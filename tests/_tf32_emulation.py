"""A TF32 emulation of the CUDA kernels' split-TF32 products, for the CPU
tests of their numerics (``test_torch_mlstm_split.py``,
``test_torch_flash_split.py``); kept here, not in the port's API.

The kernels take each float32 product on the tensor cores as three TF32
products: ``x = hi + lo`` with ``hi = tf32(x)`` and ``lo = tf32(x - hi)``
(``cvt.rna``: a 10-bit mantissa, round to nearest, ties away from zero),
and ``a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b``. The emulation sums the
exact TF32 products in float64: the card's accumulation order is for
``chip_smoke.py`` to hold."""
import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10-bit mantissa, ties away from
    zero), by integer view, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_split(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels' three TF32 products."""
    (ah, al), (bh, bl) = split(a), split(b)
    d = torch.float64
    return (al.to(d) @ bh.to(d) + ah.to(d) @ bl.to(d)
            + ah.to(d) @ bh.to(d)).to(torch.float32)


def mm_one_pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as one TF32 product."""
    d = torch.float64
    return (tf32(a).to(d) @ tf32(b).to(d)).to(torch.float32)
