"""Seeded case generators for the datapath kernels (numpy only).

The same generators as the JAX package's ``kernels/testing.py``, returning
numpy arrays so one case can be fed to both packages (and to the CUDA
kernels on the card). :func:`to_torch` moves a case onto a device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def to_torch(arrays, device="cpu"):
    """A case (tuple, dict or array) with every numpy array turned into an
    int32 tensor on ``device`` (None entries and ints pass through)."""
    if isinstance(arrays, dict):
        return {k: to_torch(v, device) for k, v in arrays.items()}
    if isinstance(arrays, (tuple, list)):
        return type(arrays)(to_torch(v, device) for v in arrays)
    if isinstance(arrays, np.ndarray):
        return torch.from_numpy(
            np.ascontiguousarray(arrays, np.int32)).to(device)
    return arrays


def selcopy_case(rng: np.random.Generator, b: int = 2, page: int = 8,
                 pps: int = 4, meta_max: int = 16) -> Tuple:
    """(stream, meta_len, total_len, pool_with_scratch, tables) with random
    parse boundaries; the pool's LAST row is the reserved scratch page
    (slice it off for legacy-mode calls)."""
    s = meta_max + pps * page
    p_total = b * pps + 2
    stream = np.asarray(rng.integers(1, 1000, (b, s)), np.int32)
    meta_len, total_len = [], []
    tables = np.full((b, pps), -1, np.int32)
    ctr = 0
    for i in range(b):
        ml = int(rng.integers(0, meta_max + 1))
        pl = int(rng.integers(0, pps * page + 1))
        meta_len.append(ml)
        total_len.append(ml + pl)
        for j in range(-(-pl // page)):
            tables[i, j] = ctr
            ctr += 1
    pool = np.asarray(rng.integers(0, 5, (p_total + 1, page)), np.int32)
    return (stream, np.asarray(meta_len, np.int32),
            np.asarray(total_len, np.int32), pool, np.asarray(tables))


def selcopy_crypto_case(rng: np.random.Generator, b: int = 2, page: int = 8,
                        pps: int = 4, meta_max: int = 16) -> Tuple:
    """A :func:`selcopy_case` plus a [B, S] int32 keystream operand — 31-bit
    values on the payload lanes (the kTLS-analogue hw mode), zero elsewhere,
    exactly as the batched datapath builds it."""
    stream, ml, tl, pool, tables = selcopy_case(rng, b=b, page=page, pps=pps,
                                                meta_max=meta_max)
    s = stream.shape[1]
    ks = rng.integers(0, 1 << 31, (b, s)).astype(np.int32)
    pos = np.arange(s)[None, :]
    payload_lane = (pos >= np.array(ml)[:, None]) & (pos < np.array(tl)[:, None])
    ks = np.where(payload_lane, ks, 0).astype(np.int32)
    return stream, ml, tl, pool, tables, np.asarray(ks)


def selgather_case(rng: np.random.Generator, b: int = 2, page: int = 8,
                   pps: int = 4, p_total: int = 0) -> Tuple:
    """(pool_with_scratch, tables, lengths, keystream) for the egress
    gather kernel: random page contents, random per-row lengths in
    [0, pps*page], valid table prefixes, a payload-relative 31-bit
    keystream zeroed past each length (exactly as forward_batch builds
    it)."""
    p_total = p_total or b * pps + 2
    pool = np.asarray(rng.integers(1, 1000, (p_total + 1, page)), np.int32)
    tables = np.full((b, pps), -1, np.int32)
    lengths = []
    ctr = 0
    for i in range(b):
        ln = int(rng.integers(0, pps * page + 1))
        lengths.append(ln)
        for j in range(-(-ln // page)):
            tables[i, j] = ctr % p_total
            ctr += 1
    ks = rng.integers(0, 1 << 31, (b, pps * page)).astype(np.int32)
    pos = np.arange(pps * page)[None, :]
    ks = np.where(pos < np.array(lengths)[:, None], ks, 0).astype(np.int32)
    return (pool, np.asarray(tables), np.asarray(lengths, np.int32),
            np.asarray(ks))


def policy_case(rng: np.random.Generator, b: int = 4, meta_max: int = 16,
                r: int = 6, k: int = 3) -> Tuple:
    """(meta, meta_len, cond_off, cond_lo, cond_hi, keystream) for the
    policy-match kernel: random metadata rows with random valid lengths, a
    dense [R, K] condition table mixing padding slots (-1), in-range and
    out-of-range offsets, and narrow/wide value bands (so matches, misses
    and no-match sentinels all occur), plus a [B, M] 31-bit keystream
    zeroed past each row's metadata (the hw-kTLS operand: the kernel
    matches meta XOR keystream)."""
    meta = rng.integers(0, 200, (b, meta_max)).astype(np.int32)
    meta_len = rng.integers(1, meta_max + 1, b).astype(np.int32)
    cond_off = rng.integers(-1, meta_max + 3, (r, k)).astype(np.int32)
    lo = rng.integers(0, 200, (r, k)).astype(np.int32)
    width = rng.integers(0, 120, (r, k)).astype(np.int32)
    ks = rng.integers(0, 1 << 31, (b, meta_max)).astype(np.int32)
    pos = np.arange(meta_max)[None, :]
    ks = np.where(pos < meta_len[:, None], ks, 0).astype(np.int32)
    return (np.asarray(meta), np.asarray(meta_len), np.asarray(cond_off),
            np.asarray(lo), np.asarray((lo + width).astype(np.int32)),
            np.asarray(ks))


def policy_live_column(rng: np.random.Generator, r: int) -> np.ndarray:
    """A random [R] int32 backend-health rule mask for the policy-match
    kernel's ``live`` operand: mostly-live rows with a sprinkling of dead
    ones (the HealthTable shape under partial backend failure), never
    all-dead so first-match and no-match sentinels both still occur."""
    live = (rng.random(r) < 0.7).astype(np.int32)
    if not live.any():
        live[int(rng.integers(0, r))] = 1
    return np.asarray(live)


def policy_payload_case(rng: np.random.Generator, b: int = 4,
                        meta_max: int = 16, r: int = 6, k: int = 3,
                        w: int = 8) -> Tuple:
    """A :func:`policy_case` where ~a third of the conditions are remapped
    to *payload-prefix* slots (``offset <= -2`` encodes first-anchored-page
    position ``-offset - 2``, in-window and past-window positions both
    drawn), plus the [B, W] plaintext first-page window and the [B]
    payload lengths the match gates on. Returns (meta, meta_len, cond_off,
    cond_lo, cond_hi, keystream, payload, payload_len)."""
    meta, ml, off, lo, hi, ks = policy_case(rng, b=b, meta_max=meta_max,
                                            r=r, k=k)
    off = np.array(off)
    sel = rng.random((r, k)) < 0.35
    ppos = rng.integers(0, w + 3, (r, k))
    off = np.where(sel, -2 - ppos, off).astype(np.int32)
    payload = rng.integers(0, 200, (b, w)).astype(np.int32)
    payload_len = rng.integers(0, w + 1, b).astype(np.int32)
    return (meta, ml, np.asarray(off), lo, hi, ks,
            np.asarray(payload), np.asarray(payload_len))


def fused_round_case(rng: np.random.Generator, b: int = 2, page: int = 8,
                     pps: int = 4, meta_max: int = 16, r: int = 6,
                     k: int = 3) -> dict:
    """Full operand bundle for the one-kernel fused round: a crypto
    selective-copy case plus a payload-relative TX keystream (zeroed past
    each payload length), a policy table mixing metadata / padding /
    payload-prefix conditions, a live health column, and a
    standalone-contract metadata keystream. Preserves the fused-round
    caller invariant ``S = meta_max + pps*page >= meta_len + pps*page``.
    Returned as a dict keyed by :func:`repro_torch.kernels.ops.fused_round`
    argument names (drop keys to exercise the optional-operand matrix)."""
    return fused_operands(rng, *selcopy_crypto_case(
        rng, b=b, page=page, pps=pps, meta_max=meta_max), meta_max=meta_max,
        r=r, k=k)


def fused_operands(rng: np.random.Generator, stream, ml, tl, pool, tables,
                   ks, *, meta_max: int, r: int, k: int) -> dict:
    """A selective-copy crypto case completed into a :func:`fused_round_case`
    bundle: TX keystream, policy table, live column and metadata
    keystream drawn from ``rng``."""
    b, pps = tables.shape
    page = pool.shape[1]
    mlv, tlv = np.array(ml), np.array(tl)
    plen = tlv - mlv
    tx = rng.integers(0, 1 << 31, (b, pps * page)).astype(np.int32)
    pos = np.arange(pps * page)[None, :]
    tx = np.where(pos < plen[:, None], tx, 0).astype(np.int32)
    cond_off = rng.integers(-1, meta_max + 3, (r, k)).astype(np.int32)
    pay = rng.random((r, k)) < 0.3
    ppos = rng.integers(0, page + 3, (r, k))
    cond_off = np.where(pay, -2 - ppos, cond_off).astype(np.int32)
    lo = rng.integers(0, 1200, (r, k)).astype(np.int32)
    width = rng.integers(0, 800, (r, k)).astype(np.int32)
    mks = rng.integers(0, 1 << 31, (b, meta_max)).astype(np.int32)
    mks = np.where(np.arange(meta_max)[None, :] < mlv[:, None], mks, 0)
    return dict(stream=stream, meta_len=ml, total_len=tl, pool=pool,
                tables=tables, keystream=ks, tx_keystream=np.asarray(tx),
                cond_off=np.asarray(cond_off), cond_lo=np.asarray(lo),
                cond_hi=np.asarray((lo + width).astype(np.int32)),
                live=policy_live_column(rng, r),
                meta_ks=np.asarray(mks.astype(np.int32)))


def edge_fused_round_case(seed: int = 99, page: int = 8, pps: int = 3,
                          meta_max: int = 8, r: int = 6, k: int = 3) -> dict:
    """:func:`edge_rows_case` as a :func:`fused_round_case` bundle (policy
    table, live column, both keystreams and the metadata keystream drawn
    from ``seed + 1``): rows with ``meta_len`` 0, 5 and ``meta_max``, so
    one payload window starts off a 16-byte boundary, and
    ``S = meta_max + pps*page``, odd for an odd ``meta_max``."""
    return fused_operands(np.random.default_rng(seed + 1),
                          *edge_rows_case(seed, page=page, pps=pps,
                                          meta_max=meta_max),
                          meta_max=meta_max, r=r, k=k)


def edge_rows_case(seed: int = 99, page: int = 8, pps: int = 3,
                   meta_max: int = 8) -> Tuple:
    """A selective-copy case of three edge rows: ``meta_len == 0``;
    ``payload_len == 0`` with an all ``-1`` table row; and a payload that
    fills every table slot. Returns (stream, meta_len, total_len,
    pool_with_scratch, tables, keystream)."""
    s = meta_max + pps * page
    rng = np.random.default_rng(seed)
    stream = rng.integers(1, 1000, (3, s)).astype(np.int32)
    meta_len = np.array([0, min(5, meta_max), meta_max], np.int32)
    total_len = np.array([min(20, pps * page), meta_len[1],
                          meta_max + pps * page], np.int32)
    tables = np.full((3, pps), -1, np.int32)
    tables[0, : -(-int(total_len[0]) // page)] = np.arange(
        -(-int(total_len[0]) // page))
    tables[2] = np.arange(pps, 2 * pps)
    pool = rng.integers(0, 5, (2 * pps + 1, page)).astype(np.int32)
    ks = rng.integers(0, 1 << 31, (3, s)).astype(np.int32)
    return stream, meta_len, total_len, pool, tables, ks


def selcopy_edge_case(seed: int = 7, page: int = 1024, pps: int = 16,
                      meta_max: int = 256, s_tail: int = 0) -> Tuple:
    """A selective-copy case of eight rows at the edges of the CUDA
    kernel's 16-byte groups, with ``S = meta_max + pps*page - 4 + s_tail``
    (so ``S % 4 == s_tail % 4``): ``meta_len`` 0, 1, 2 and 3 (the payload
    at every phase against a 16-byte boundary) over most of the table, row
    3 with ``-1`` slots between its valid ones; ``meta_len == meta_max -
    1`` with a payload that ends exactly at S; ``meta_len == meta_max``
    with one cut by S (``total_len`` past S); an empty row (all ``-1``);
    and ``meta_len == meta_max`` with a payload of 5 tokens. Payloads stay
    within ``pps*page``. The keystream is random on every lane. Returns
    (stream, meta_len, total_len, pool_with_scratch, tables, keystream)."""
    rng = np.random.default_rng(seed)
    full = pps * page
    s = meta_max + full - 4 + s_tail
    meta_len = np.array([0, 1, 2, 3, meta_max - 1, meta_max, 0, meta_max],
                        np.int32)
    total_len = np.array([full - 4, full, 2 + full // 2 + 3, 3 + full - 2,
                          s, s + 9, 0, meta_max + 5], np.int32)
    b = len(meta_len)
    tables = np.full((b, pps), -1, np.int32)
    ctr = 0
    for i in range(b):
        plen = min(int(total_len[i]), s) - int(meta_len[i])
        for j in range(-(-plen // page)):
            if i == 3 and j % 2 == 1:
                continue                     # -1 between valid slots
            tables[i, j] = ctr
            ctr += 1
    perm = rng.permutation(ctr + 2)[:ctr].astype(np.int32)
    tables = np.where(tables >= 0, perm[np.maximum(tables, 0)], -1)
    stream = rng.integers(1, 1000, (b, s)).astype(np.int32)
    pool = rng.integers(0, 5, (ctr + 3, page)).astype(np.int32)
    ks = rng.integers(0, 1 << 31, (b, s)).astype(np.int32)
    return (stream, meta_len, total_len, pool, tables.astype(np.int32), ks)


def policy_edge_case(rng: np.random.Generator, b: int = 8,
                     meta_max: int = 16, r: int = 33, k: int = 33,
                     w: int = 8, fail_first: int = 0) -> Tuple:
    """A policy case whose conditions mostly hold, so that rules of many
    conditions still match now and then: a third padding, a third
    metadata conditions (offsets mostly below 4, some up to ``meta_max +
    1``), a third payload conditions (positions mostly below 2, some at
    ``W - 1``, ``W`` and ``W + 1``, past the window); most bands are the
    whole value range, a few narrow. Row 0 has ``meta_len`` 0 and
    ``payload_len`` 0, row 1 ``meta_len == meta_max`` and ``payload_len ==
    W``. Returns :func:`policy_payload_case`'s tuple."""
    meta = rng.integers(0, 200, (b, meta_max)).astype(np.int32)
    ml = rng.integers(0, meta_max + 1, b).astype(np.int32)
    pl = rng.integers(0, w + 1, b).astype(np.int32)
    ml[0], pl[0] = 0, 0
    ml[1], pl[1] = meta_max, w
    kind = rng.integers(0, 3, (r, k))
    moff = np.where(rng.random((r, k)) < 0.9, rng.integers(0, 4, (r, k)),
                    rng.integers(0, meta_max + 2, (r, k)))
    ppos = np.where(rng.random((r, k)) < 0.9, rng.integers(0, 2, (r, k)),
                    rng.choice([w - 1, w, w + 1], (r, k)))
    off = np.where(kind == 0, -1, np.where(kind == 1, moff, -2 - ppos))
    narrow = rng.random((r, k)) < 0.05
    lo = np.where(narrow, rng.integers(0, 200, (r, k)), 0).astype(np.int32)
    hi = np.where(narrow, lo + rng.integers(0, 60, (r, k)), 199)
    slot = rng.integers(0, k, fail_first) if k else []
    for rule, c in enumerate(slot):
        off[rule, c], lo[rule, c], hi[rule, c] = 0, 1, 0
    ks = rng.integers(0, 1 << 31, (b, meta_max)).astype(np.int32)
    ks = np.where(np.arange(meta_max)[None, :] < ml[:, None], ks, 0)
    payload = rng.integers(0, 200, (b, w)).astype(np.int32)
    return (meta, ml, off.astype(np.int32), lo, hi.astype(np.int32),
            ks.astype(np.int32), payload, pl)
