"""``kernels/csrc/paged_attention.cu``: one launch a layer a decode step,
over every row of the step. A row that decodes reads its query, its whole
K/V context once (the new token's included) and writes its output;
rows parked on the scratch page are padding and count nothing."""
from __future__ import annotations

from typing import List, Tuple

KERNEL = "paged_attention_kernel"
F32 = 4


def launch(model, ctx_lens: List[int]) -> Tuple[float, float]:
    """``(flops, bytes)`` of one layer's launch over rows of these contexts."""
    hq, hkv, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    flops = sum(4.0 * c * hq * hd for c in ctx_lens)
    kv = sum(c * 2 * hkv * hd * F32 for c in ctx_lens)
    q_out = len(ctx_lens) * hq * (2 * hd + 2) * F32   # q; acc, m and l out
    return flops, float(kv + q_out)


def launches(ctx) -> List[Tuple[float, float]]:
    out = []
    for st in ctx.trace_steps:
        if st.decode_ctx:
            out += [launch(ctx.model, st.decode_ctx)] * ctx.model["num_layers"]
    return out
