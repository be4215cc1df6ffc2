"""Python wrappers of the kTLS-analogue bench's CUDA kernels
(``csrc/ktls_attention.cu``): decode attention over float32 or int8 K/V,
and the dequantise pass.

They replace no Pallas kernel: they compute the three jitted functions of
``benchmarks/bench_ktls_analogue.py`` (``plain``, ``sw_mode``,
``hw_mode``), whose point is that ``hw_mode`` dequantises inside the
attention's read. Each wrapper takes CUDA tensors only: it checks device,
dtype, shape and contiguity, allocates its output with ``torch.empty``,
launches on ``torch.cuda.current_stream()`` and raises if the launch is
refused. It never falls back to the plain version
(:func:`repro_torch.kernels.ref.ktls_attention_ref`,
:func:`~repro_torch.kernels.ref.ktls_dequant_ref`);
:mod:`repro_torch.kernels.ops` picks between the two by the tensors'
device. :data:`LAUNCHES` counts each kernel's launches, bumped only where
it is launched, and :data:`KV_LAUNCHES` splits ``ktls_attention``'s by the
type of its K/V.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES = {"ktls_attention": 0, "ktls_dequant": 0}
#: ``ktls_attention``'s launches by the type of its K/V
KV_LAUNCHES = {"float32": 0, "int8": 0}

#: the one head dim the attention kernel is instantiated for (the bench's,
#: libra-proxy-125m's)
HEAD_DIM = 64
_MAX_GRID_X = 2 ** 31 - 1
F32, I8 = torch.float32, torch.int8
_check = _build.check_tensor


def reset_launches() -> None:
    _build.reset_counts(LAUNCHES)
    _build.reset_counts(KV_LAUNCHES)


def ktls_attention(q: torch.Tensor, kv: torch.Tensor,
                   amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``softmax(q k^T) v`` ``[B, Hq, hd]`` of ``q [B, Hq, hd]`` over every
    key of ``kv [B, ctx, 2, Hkv, hd]``, unscaled and unmasked
    (``ktls_attention_ref`` semantics). ``kv`` is float32, or int8 with
    ``amax [B, ctx, 2, Hkv, 1]`` float32, dequantised in registers."""
    if q.dim() != 3 or kv.dim() != 5:
        raise ValueError(f"ktls_attention: q {tuple(q.shape)} must be "
                         f"[B, Hq, hd], kv {tuple(kv.shape)} "
                         "[B, ctx, 2, Hkv, hd]")
    b, hq, hd = q.shape
    ctx, hkv = kv.shape[1], kv.shape[3]
    dev = q.device
    int8 = amax is not None
    _check("q", q, dtype=F32)
    _check("kv", kv, (b, ctx, 2, hkv, hd), dtype=I8 if int8 else F32,
           device=dev)
    _check("amax", amax, (b, ctx, 2, hkv, 1), dtype=F32, device=dev)
    if hd != HEAD_DIM:
        raise ValueError(f"ktls_attention: head_dim {hd}, the kernel takes "
                         f"{HEAD_DIM}")
    if hkv < 1 or hq % hkv or b * hq > _MAX_GRID_X:
        raise ValueError(f"ktls_attention: bad heads Hq={hq} Hkv={hkv} or "
                         f"batch {b}")
    out = torch.empty((b, hq, hd), dtype=F32, device=dev)
    if b == 0 or hq == 0:
        return out
    if ctx == 0:                     # the plain version's empty softmax
        return out.zero_()
    _build.launch("ktls_attention", dev, q.data_ptr(), kv.data_ptr(),
                  amax.data_ptr() if int8 else None, out.data_ptr(), b, hq,
                  hkv, ctx, hd, int(int8))
    _build.count_launch(LAUNCHES, "ktls_attention")
    _build.count_launch(KV_LAUNCHES, "int8" if int8 else "float32")
    return out


def ktls_dequant(kq: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """``float(kq) * amax / 127`` of int8 ``kq [..., hd]`` and float32
    ``amax [..., 1]`` into a new float32 tensor of ``kq``'s shape
    (``ktls_dequant_ref`` semantics, bit for bit)."""
    if kq.dim() < 1:
        raise ValueError("ktls_dequant: kq must have a last axis")
    dev = kq.device
    _check("kq", kq, dtype=I8)
    _check("amax", amax, (*kq.shape[:-1], 1), dtype=F32, device=dev)
    out = torch.empty(kq.shape, dtype=F32, device=dev)
    hd = kq.shape[-1]
    rows = kq.numel() // hd if hd else 0
    if rows == 0:
        return out
    if rows > _MAX_GRID_X:
        raise ValueError(f"ktls_dequant: {rows} rows, at most {_MAX_GRID_X}")
    _build.launch("ktls_dequant", dev, kq.data_ptr(), amax.data_ptr(),
                  out.data_ptr(), rows, hd)
    _build.count_launch(LAUNCHES, "ktls_dequant")
    return out
