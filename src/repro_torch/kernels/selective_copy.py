"""Python wrappers of the four batched-datapath CUDA kernels (``csrc/``).

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on
``torch.cuda.current_stream()`` and raises if the launch is refused. It
never falls back to the plain version (:mod:`repro_torch.kernels.ref`);
:mod:`repro_torch.kernels.ops` picks between the two by the tensors'
device. :data:`LAUNCHES` counts the launches of each kernel, bumped only
where the kernel is launched, and :data:`FUSED_DEPTHS` the ring depth of
each ``fused_round`` launch.

Every kernel is a hand-written CUDA C++ port of a Pallas TPU kernel of
the JAX package (file:line in each ``.cu`` header); data is int32 and the
pool is updated in place.
"""
from __future__ import annotations

import functools
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES = {"selective_copy": 0, "selective_gather": 0, "policy_match": 0,
            "fused_round": 0}
#: ``fused_round`` launches per ring depth since the last
#: :func:`reset_launches`
FUSED_DEPTHS: Dict[int, int] = {}
_DEPTH_LOCK = threading.Lock()

_MAX_GRID_Y = 65535

#: tokens of one ring tile (``kTile`` in ``csrc/datapath.cuh``): a page
#: larger than this is several tiles
TILE = 1024
#: bytes of the policy table (``cond_off``, ``cond_lo``, ``cond_hi``,
#: ``live``) that ``fused_round`` copies into shared memory once a block;
#: a larger table is read from global memory (``kTableBudget``)
TABLE_BUDGET = 8192
#: ``fused_round``'s ring depth at ``n_buffers=0``, the depth measured
#: best at the deployment's shape (PERF.md, section 6)
DEFAULT_FUSED_DEPTH = 2


def ring_depth(n_buffers: int) -> int:
    """``fused_round``'s ring depth for an ``n_buffers`` argument: the
    default for 0, ``n_buffers`` itself from 2 up. 1 and negative values
    raise ``ValueError``, as the TPU kernel refuses them."""
    if n_buffers == 0:
        return DEFAULT_FUSED_DEPTH
    if n_buffers < 2:
        raise ValueError(f"fused_round: n_buffers={n_buffers}; expected 0 "
                         "(the default depth) or a ring depth >= 2")
    return int(n_buffers)


def _up4(n: int) -> int:
    return (n + 3) // 4 * 4


def fused_round_smem_bytes(depth: int, *, page: int, meta_max: int,
                           has_ks: bool, has_policy: bool, has_meta_ks: bool,
                           r: int, k: int) -> int:
    """Dynamic shared memory of one ``fused_round`` block, as
    ``ring_layout`` in ``csrc/fused_round.cu`` lays it out: ``depth``
    slots (a tile window of the stream and of the RX keystream, and for
    the metadata task its window and the metadata keystream's), a
    32-byte task record and an 8-byte barrier a slot, two staged task
    records, and the policy table when it fits :data:`TABLE_BUDGET`."""
    tile = _up4(min(page, TILE)) + 4
    mw = _up4(min(meta_max, TILE))
    off_meta = tile * (1 + has_ks) if has_policy else 0
    slot = max(tile * (1 + has_ks),
               off_meta + mw * (1 + (has_policy and has_meta_ks)))
    table = 4 * (3 * r * k + r) if has_policy else 0
    table = _up4(table) if table <= TABLE_BUDGET else 0
    return depth * (4 * slot + 32 + 8) + 2 * 32 + table


def _smem_limit(dev: torch.device) -> Optional[int]:
    return getattr(torch.cuda.get_device_properties(dev),
                   "shared_memory_per_block_optin", None)


def reset_launches() -> None:
    _build.reset_counts(LAUNCHES)
    with _DEPTH_LOCK:
        FUSED_DEPTHS.clear()


def _count_depth(depth: int) -> None:
    """Add one to ``FUSED_DEPTHS[depth]`` (from 0 for a depth not yet
    launched), exact when several threads launch."""
    with _DEPTH_LOCK:
        FUSED_DEPTHS[depth] = FUSED_DEPTHS.get(depth, 0) + 1


#: operand check of the datapath kernels: every operand is int32
_check = functools.partial(_build.check_tensor, dtype=torch.int32)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(name: str, dev: torch.device, *args) -> None:
    """Launch ``libra_<name>`` on ``dev``'s current stream (raising if the
    launch was refused) and count it."""
    _build.launch(name, dev, *args)
    _build.count_launch(LAUNCHES, name)


def selective_copy(stream: torch.Tensor, meta_len: torch.Tensor,
                   total_len: torch.Tensor, pool: torch.Tensor,
                   tables: torch.Tensor, *, meta_max: int,
                   keystream: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RX plane: ``(meta [B, meta_max], pool)``, the pool anchored in place
    (``selective_copy_ref`` / ``selective_copy_crypto_ref`` semantics)."""
    b, s = stream.shape
    p_ext, page = pool.shape
    pps = tables.shape[1]
    dev = stream.device
    _check("stream", stream)
    _check("meta_len", meta_len, (b,), device=dev)
    _check("total_len", total_len, (b,), device=dev)
    _check("pool", pool, device=dev)
    _check("tables", tables, (b, pps), device=dev)
    _check("keystream", keystream, (b, s), device=dev)
    if s < 1 or p_ext < 1 or page < 1 or 1 + pps > _MAX_GRID_Y:
        raise ValueError(f"selective_copy: bad shapes S={s} pool={p_ext}x"
                         f"{page} pps={pps}")
    meta = torch.empty((b, meta_max), dtype=torch.int32, device=dev)
    if b == 0:
        return meta, pool
    _launch("selective_copy", dev, _ptr(stream), _ptr(keystream),
            _ptr(meta_len), _ptr(total_len), _ptr(tables), _ptr(pool),
            _ptr(meta), b, s, p_ext, page, pps, meta_max)
    return meta, pool


def selective_gather(pool: torch.Tensor, tables: torch.Tensor,
                     lengths: torch.Tensor, *,
                     keystream: Optional[torch.Tensor] = None,
                     ) -> torch.Tensor:
    """TX plane: ``out [B, pps*page]`` gathered from the pool
    (``selective_gather_ref`` semantics). The pool is only read."""
    p_ext, page = pool.shape
    b, pps = tables.shape
    dev = pool.device
    _check("pool", pool)
    _check("tables", tables, device=dev)
    _check("lengths", lengths, (b,), device=dev)
    _check("keystream", keystream, (b, pps * page), device=dev)
    if p_ext < 1 or page < 1 or pps > _MAX_GRID_Y:
        raise ValueError(f"selective_gather: bad shapes pool={p_ext}x{page} "
                         f"pps={pps}")
    out = torch.empty((b, pps * page), dtype=torch.int32, device=dev)
    if b == 0 or pps == 0:
        return out
    _launch("selective_gather", dev, _ptr(pool), _ptr(tables),
            _ptr(lengths), _ptr(keystream), _ptr(out), b, p_ext, page, pps)
    return out


def policy_match(meta: torch.Tensor, meta_len: torch.Tensor,
                 cond_off: torch.Tensor, cond_lo: torch.Tensor,
                 cond_hi: torch.Tensor, *,
                 keystream: Optional[torch.Tensor] = None,
                 live: Optional[torch.Tensor] = None,
                 payload: Optional[torch.Tensor] = None,
                 payload_len: Optional[torch.Tensor] = None,
                 ) -> torch.Tensor:
    """First matching rule per message, ``[B]`` int32, ``R`` for none
    (``policy_match_ref`` semantics)."""
    b, m = meta.shape
    r, k = cond_off.shape
    dev = meta.device
    _check("meta", meta)
    _check("meta_len", meta_len, (b,), device=dev)
    _check("cond_off", cond_off, device=dev)
    _check("cond_lo", cond_lo, (r, k), device=dev)
    _check("cond_hi", cond_hi, (r, k), device=dev)
    _check("keystream", keystream, (b, m), device=dev)
    _check("live", live, (r,), device=dev)
    w = 0
    if payload is not None:
        w = payload.shape[1]
        _check("payload", payload, (b, w), device=dev)
        if payload_len is None:
            raise ValueError("policy_match: payload needs payload_len")
        _check("payload_len", payload_len, (b,), device=dev)
    out = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    _launch("policy_match", dev, _ptr(meta), _ptr(meta_len), _ptr(cond_off),
            _ptr(cond_lo), _ptr(cond_hi), _ptr(keystream), _ptr(live),
            _ptr(payload),
            _ptr(payload_len if payload is not None else None), _ptr(out),
            b, m, r, k, w)
    return out


def fused_round(stream: torch.Tensor, meta_len: torch.Tensor,
                total_len: torch.Tensor, pool: torch.Tensor,
                tables: torch.Tensor, *, meta_max: int,
                keystream: Optional[torch.Tensor] = None,
                tx_keystream: Optional[torch.Tensor] = None,
                cond_off: Optional[torch.Tensor] = None,
                cond_lo: Optional[torch.Tensor] = None,
                cond_hi: Optional[torch.Tensor] = None,
                live: Optional[torch.Tensor] = None,
                meta_ks: Optional[torch.Tensor] = None,
                n_buffers: int = 0,
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor], torch.Tensor]:
    """One scheduling round in one launch: ``(meta, pool, verdict | None,
    out)``, the pool anchored in place (``fused_round_ref`` semantics).
    ``n_buffers`` is the depth of each block's shared-memory ring (the
    copies of a task go out ``depth - 1`` tasks ahead): 0 takes
    :data:`DEFAULT_FUSED_DEPTH`, 1 and negative values raise
    ``ValueError``, and a depth whose ring does not fit the card's shared
    memory raises ``ValueError`` with the limit. Results are identical at
    every depth."""
    depth = ring_depth(n_buffers)
    b, s = stream.shape
    p_ext, page = pool.shape
    pps = tables.shape[1]
    dev = stream.device
    _check("stream", stream)
    _check("meta_len", meta_len, (b,), device=dev)
    _check("total_len", total_len, (b,), device=dev)
    _check("pool", pool, device=dev)
    _check("tables", tables, (b, pps), device=dev)
    _check("keystream", keystream, (b, s), device=dev)
    _check("tx_keystream", tx_keystream, (b, pps * page), device=dev)
    has_policy = cond_off is not None
    r = k = 0
    if has_policy:
        r, k = cond_off.shape
        _check("cond_off", cond_off, device=dev)
        _check("cond_lo", cond_lo, (r, k), device=dev)
        _check("cond_hi", cond_hi, (r, k), device=dev)
        _check("live", live, (r,), device=dev)
        _check("meta_ks", meta_ks, (b, meta_max), device=dev)
    elif live is not None or meta_ks is not None:
        raise ValueError("fused_round: live/meta_ks need a policy table")
    if s < 1 or p_ext < 1 or page < 1 or pps < 1 or 1 + pps > _MAX_GRID_Y:
        raise ValueError(f"fused_round: bad shapes S={s} pool={p_ext}x{page} "
                         f"pps={pps}")
    meta = torch.empty((b, meta_max), dtype=torch.int32, device=dev)
    out = torch.empty((b, pps * page), dtype=torch.int32, device=dev)
    verdict = (torch.empty((b,), dtype=torch.int32, device=dev)
               if has_policy else None)
    smem = fused_round_smem_bytes(
        depth, page=page, meta_max=meta_max, has_ks=keystream is not None,
        has_policy=has_policy, has_meta_ks=meta_ks is not None, r=r, k=k)
    limit = _smem_limit(dev)
    if limit is not None and smem > limit:
        raise ValueError(f"fused_round: a ring of {depth} slots needs {smem} "
                         f"bytes of shared memory a block; the card allows "
                         f"{limit}")
    if b == 0:
        return meta, pool, verdict, out
    _launch("fused_round", dev, _ptr(stream), _ptr(keystream),
            _ptr(tx_keystream), _ptr(meta_len), _ptr(total_len), _ptr(tables),
            _ptr(pool), _ptr(meta), _ptr(out), _ptr(cond_off), _ptr(cond_lo),
            _ptr(cond_hi), _ptr(live), _ptr(meta_ks), _ptr(verdict), b, s,
            p_ext, page, pps, meta_max, r, k, depth)
    _count_depth(depth)
    return meta, pool, verdict, out
