"""Paper Fig. 6c/6d (kTLS): encryption maps to KV-cache quantisation.

The port of ``benchmarks/bench_ktls_analogue.py``: the same three regimes
of the decode-attention core, the same draws, row names and ``derived``
strings, on the card by default (``--device cuda``; ``cpu`` runs the
plain versions).

"SW kTLS" = a separate dequantise pass over the whole int8 payload into a
new float buffer each step (the encrypt-and-copy of the paper's B.1),
then the attention; "HW kTLS" = dequantisation fused into the attention's
read (the NIC-inline analogue: zero extra passes); "plain" = the attention
over float K/V. The reference's regimes are jitted functions whose point
is what XLA fuses. Here all three run through one hand-written kernel
(``csrc/ktls_attention.cu``): ``plain`` and ``sw`` over float K/V, ``sw``
after the dequantise kernel's pass, ``hw`` through its int8 instantiation,
which reads the int8 K/V and their ``amax`` and no float K/V buffer.

The shape is libra-proxy-125m's decode attention: batch 8, 12 heads of 64,
contexts 256, 1024 and 4096. Each regime is timed as the reference times
it (:func:`common.time_fn`, a warm-up and 5 calls, no cache flush between
them), so the float K/V of contexts 256 and 1024 (12.6 and 50.3 MB) may
stay in the card's 50 MB L2 from one call to the next. Quantising is
set-up, outside the timed windows.

  PYTHONPATH=src python -m benchmarks_torch.bench_ktls_analogue [--device cpu]
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from benchmarks_torch import common
from benchmarks_torch.common import csv, time_fn
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ktls_dequant_ref

#: libra-proxy-125m's decode attention: batch, query heads, KV heads, dim
B, HQ, HKV, HD = 8, 12, 12, 64
CONTEXTS = (256, 1024, 4096)


def quant(x: torch.Tensor):
    """``(q int8, amax float32 [..., 1])`` of ``x``: the reference's
    ``_quant`` in its order of operations (``round`` is half to even, as
    ``jnp.round``)."""
    amax = x.abs().amax(dim=-1, keepdim=True) + 1e-9
    q = torch.clamp(torch.round(x / amax * 127), -127, 127).to(torch.int8)
    return q, amax


def dequant(q: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """The reference's ``_dequant``: ``q * amax / 127`` in float32."""
    return ktls_dequant_ref(q, amax)


def plain(q, kv):
    return ops.ktls_attention(q, kv)


def sw_mode(q, kq, kamax):
    # separate pass: dequantise the WHOLE payload to a new buffer (the
    # encrypt-and-copy), then attend
    return ops.ktls_attention(q, ops.ktls_dequant(kq, kamax))


def hw_mode(q, kq, kamax):
    # fused: the kernel dequantises each K/V element as it reads it
    return ops.ktls_attention(q, kq, kamax)


def _tensor(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.float32)).to(device)


def main(argv: Optional[Sequence[str]] = None) -> None:
    dev = torch.device(common.bench_args(argv, __doc__).device)
    rng = np.random.default_rng(0)
    for ctx in CONTEXTS:
        q = _tensor(rng.standard_normal((B, HQ, HD)), dev)
        kv = _tensor(rng.standard_normal((B, ctx, 2, HKV, HD)), dev)
        kq, kamax = quant(kv)

        t_plain = time_fn(plain, q, kv, iters=5, device=dev)
        t_sw = time_fn(sw_mode, q, kq, kamax, iters=5, device=dev)
        t_hw = time_fn(hw_mode, q, kq, kamax, iters=5, device=dev)
        csv(f"fig6c_ktls_ctx{ctx}_plain", t_plain * 1e6, "mode=plaintext")
        csv(f"fig6c_ktls_ctx{ctx}_sw", t_sw * 1e6,
            f"slowdown_vs_plain={t_sw/t_plain:.2f} (separate pass)")
        csv(f"fig6c_ktls_ctx{ctx}_hw", t_hw * 1e6,
            f"slowdown_vs_plain={t_hw/t_plain:.2f} (fused inline)")


if __name__ == "__main__":
    main()
