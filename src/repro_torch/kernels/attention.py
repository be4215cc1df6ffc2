"""Python wrappers of the two attention CUDA kernels (``csrc/``).

Each wrapper takes float32 CUDA tensors only: it checks device, dtype,
shape and contiguity, allocates its outputs with ``torch.empty``, launches
on ``torch.cuda.current_stream()`` and raises if the launch is refused. It
never falls back to the plain version (:mod:`repro_torch.kernels.ref`);
:mod:`repro_torch.kernels.ops` picks between the two by the tensors'
device. :data:`LAUNCHES` counts the launches of each kernel, bumped only
where the kernel is launched.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES = {"paged_attention": 0, "flash_attention": 0}

#: head dims both kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 96, 128)
_MAX_GRID_YZ = 65535
F32, I32 = torch.float32, torch.int32
_check = _build.check_tensor


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(name: str, dev: torch.device, *args) -> None:
    _build.launch(name, dev, *args)
    LAUNCHES[name] += 1


def paged_attention(q: torch.Tensor, pool: torch.Tensor,
                    tables: torch.Tensor, page_pos: torch.Tensor,
                    seq_lens: torch.Tensor, *, window: int = 0,
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial ``(acc [B, Hq, hd], m [B, Hq], l [B, Hq])`` of decode
    attention over the anchored pages (``paged_attention_ref``
    semantics). ``pool`` is one layer's ``[P, page, 2, Hkv, hd]`` view."""
    if q.dim() != 3 or pool.dim() != 5:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} must be "
                         f"[B, Hq, hd], pool {tuple(pool.shape)} "
                         "[P, page, 2, Hkv, hd]")
    b, hq, hd = q.shape
    _p, page, two, hkv, hd_p = pool.shape
    pps = tables.shape[1] if tables.dim() == 2 else -1
    dev = q.device
    _check("q", q, dtype=F32)
    _check("pool", pool, dtype=F32, device=dev)
    _check("tables", tables, (b, pps), dtype=I32, device=dev)
    _check("page_pos", page_pos, (b, pps), dtype=I32, device=dev)
    _check("seq_lens", seq_lens, (b,), dtype=I32, device=dev)
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {hd} not in {HEAD_DIMS}")
    if two != 2 or hd_p != hd or hkv < 1 or hq % hkv or page < 1 or \
            b > _MAX_GRID_YZ:
        raise ValueError(f"paged_attention: bad shapes q {tuple(q.shape)} "
                         f"pool {tuple(pool.shape)}")
    acc = torch.empty((b, hq, hd), dtype=torch.float32, device=dev)
    m = torch.empty((b, hq), dtype=torch.float32, device=dev)
    l = torch.empty((b, hq), dtype=torch.float32, device=dev)
    if b == 0 or hq == 0:
        return acc, m, l
    _launch("paged_attention", dev, q.data_ptr(), pool.data_ptr(),
            tables.data_ptr(), page_pos.data_ptr(), seq_lens.data_ptr(),
            acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, hq, hkv, hd,
            page, pps, int(window))
    return acc, m, l


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal / windowed GQA attention ``[B, Hq, Sq, hd]`` at positions
    ``arange`` (``flash_attention_ref`` semantics), float32."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} must be "
                         f"[B, Hq, Sq, hd], k {tuple(k.shape)} "
                         "[B, Hkv, Skv, hd]")
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dev = q.device
    _check("q", q, dtype=F32)
    _check("k", k, (b, hkv, skv, hd), dtype=F32, device=dev)
    _check("v", v, (b, hkv, skv, hd), dtype=F32, device=dev)
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if hkv < 1 or hq % hkv or hq > _MAX_GRID_YZ or b > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention: bad heads Hq={hq} Hkv={hkv} "
                         f"or batch {b}")
    out = torch.empty_like(q)
    if b == 0 or hq == 0 or sq == 0:
        return out
    _launch("flash_attention", dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, hq, hkv, sq, skv, hd, int(bool(causal)),
            int(window))
    return out
