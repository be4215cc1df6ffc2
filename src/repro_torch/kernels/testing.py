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
    stream, ml, tl, pool, tables, ks = selcopy_crypto_case(
        rng, b=b, page=page, pps=pps, meta_max=meta_max)
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
