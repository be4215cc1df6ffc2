"""Python wrapper of the mLSTM scan CUDA kernel (``csrc/mlstm_scan.cu``).

It takes float32 CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates ``h`` and the final state with ``torch.empty``,
launches on ``torch.cuda.current_stream()`` and raises if the launch is
refused. It never falls back to the plain version
(:func:`repro_torch.kernels.ref.mlstm_chunked_ref`);
:mod:`repro_torch.kernels.ops` picks between the two by the tensors'
device. :data:`LAUNCHES` counts the kernel's launches, bumped only where
it is launched.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

#: launches since the last :func:`reset_launches`
LAUNCHES = {"mlstm_scan": 0}

#: head dims the kernel is instantiated for: the tests' and the reduced
#: config's (16-64) and xlstm-350m's (512)
HEAD_DIMS = (16, 32, 64, 512)
#: chunk lengths it is instantiated for
CHUNKS = (16, 32, 64)
_MAX_GRID_X = 2 ** 31 - 1
F32 = torch.float32
_check = _build.check_tensor


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_i: torch.Tensor, log_f: torch.Tensor, *, chunk: int = 64,
               ) -> Tuple[torch.Tensor,
                          Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """``(h [B, H, S, dh], (C [B, H, dh, dh], n [B, H, dh], m [B, H]))`` of
    the stabilised chunkwise mLSTM over ``q``/``k``/``v [B, H, S, dh]`` and
    the gates ``log_i``/``log_f [B, H, S]`` (``mlstm_chunked_ref``
    semantics), from the zero state. ``S`` need not be a multiple of
    ``chunk``."""
    if q.dim() != 4:
        raise ValueError(f"mlstm_scan: q {tuple(q.shape)} must be "
                         "[B, H, S, dh]")
    b, h, s, dh = q.shape
    dev = q.device
    _check("q", q, dtype=F32)
    _check("k", k, (b, h, s, dh), dtype=F32, device=dev)
    _check("v", v, (b, h, s, dh), dtype=F32, device=dev)
    _check("log_i", log_i, (b, h, s), dtype=F32, device=dev)
    _check("log_f", log_f, (b, h, s), dtype=F32, device=dev)
    if dh not in HEAD_DIMS:
        raise ValueError(f"mlstm_scan: head_dim {dh} not in {HEAD_DIMS}")
    if chunk not in CHUNKS:
        raise ValueError(f"mlstm_scan: chunk {chunk} not in {CHUNKS}")
    if b * h > _MAX_GRID_X:
        raise ValueError(f"mlstm_scan: B*H = {b * h} blocks is too many")
    out = torch.empty_like(q)
    c = torch.empty((b, h, dh, dh), dtype=F32, device=dev)
    n = torch.empty((b, h, dh), dtype=F32, device=dev)
    m = torch.empty((b, h), dtype=F32, device=dev)
    if b * h == 0:
        return out, (c, n, m)
    _build.launch("mlstm_scan", dev, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), log_i.data_ptr(), log_f.data_ptr(),
                  out.data_ptr(), c.data_ptr(), n.data_ptr(), m.data_ptr(),
                  b * h, s, dh, chunk)
    LAUNCHES["mlstm_scan"] += 1
    return out, (c, n, m)
