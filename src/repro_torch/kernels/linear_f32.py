"""Python wrapper of the prefill's float32 product on the tensor cores
(``csrc/linear_f32.cu``): ``x [..., K] @ w [K, N]`` as three TF32 products
of each operand's hi and lo halves, float32 accuracy.

The wrapper takes float32 CUDA tensors only: it checks device, dtype,
shape, contiguity and the 16-byte alignment and widths that the kernel's
TMA loads need (``K`` and ``N`` multiples of 4), allocates the output with
``torch.empty``, launches on ``torch.cuda.current_stream()`` and raises if
the launch is refused. It never falls back to ``torch.matmul``;
:mod:`repro_torch.kernels.ops` picks between the two by the tensors'
device. :data:`LAUNCHES` counts the launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

#: launches since the last :func:`reset_launches`
LAUNCHES = {"linear_f32": 0}

F32 = torch.float32
_MAX_ROWS = 2 ** 31 - 1
_check = _build.check_tensor


def reset_launches() -> None:
    _build.reset_counts(LAUNCHES)


def linear_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [K, N]``, float32, into a new ``[..., N]``
    tensor."""
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"linear_f32: x {tuple(x.shape)} must be [..., K] "
                         f"and w {tuple(w.shape)} [K, N]")
    k, n = w.shape
    dev = x.device
    _check("x", x, dtype=F32)
    _check("w", w, dtype=F32, device=dev)
    if k % 4 or n % 4:
        raise ValueError(f"linear_f32: K {k} and N {n} must be multiples of "
                         "4 (TMA reads rows of whole 16-byte units)")
    for name, t in (("x", x), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"linear_f32: {name} must start on a 16-byte "
                             "boundary")
    rows = math.prod(x.shape[:-1])
    if rows > _MAX_ROWS:
        raise ValueError(f"linear_f32: {rows} rows, at most {_MAX_ROWS}")
    out = torch.empty(tuple(x.shape[:-1]) + (n,), dtype=F32, device=dev)
    if out.numel() == 0:
        return out
    _build.launch("linear_f32", dev, x.data_ptr(), w.data_ptr(),
                  out.data_ptr(), rows, k, n)
    _build.count_launch(LAUNCHES, "linear_f32")
    return out
