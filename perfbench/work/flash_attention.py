"""``kernels/csrc/flash_attention.cu``: one launch a layer a prefill, over
every row of the admission group. Each prompt of ``L`` real tokens reads
its q, k and v once, writes its output once, and takes the causal
triangle's two products: ``4 * Hq * hd * L (L + 1) / 2`` operations. The
group's padding counts nothing."""
from __future__ import annotations

from typing import List, Tuple

KERNEL = "flash_attention_kernel"
F32 = 4


def launch(model, lens: List[int]) -> Tuple[float, float]:
    hq, hkv, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    flops = sum(4.0 * hq * hd * n * (n + 1) / 2 for n in lens)
    moved = sum(n * (2 * hq + 2 * hkv) * hd * F32 for n in lens)
    return flops, float(moved)


def launches(ctx) -> List[Tuple[float, float]]:
    out = []
    for st in ctx.trace_steps:
        if st.prefill_lens:
            out += [launch(ctx.model, st.prefill_lens)] * ctx.model["num_layers"]
    return out
