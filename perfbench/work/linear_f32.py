"""``kernels/csrc/linear_f32.cu``: the prefill's per-layer projections, one
launch each, a layer a prefill, over every row of the admission group:
``wq``, ``wk``, ``wv``, ``wo``, and a dense FFN's products (``w_gate``,
``w_up``, ``w_down`` under swiglu; ``w_up``, ``w_down`` otherwise; an MoE
layer's experts keep their own). A launch of ``x [R, K] @ w [K, N]``
counts the prompts' real rows only, ``R`` = the sum of the group's prompt
lengths: ``2 R K N`` operations, and ``x``, ``w`` and the output read or
written once, ``4 (R K + K N + R N)`` bytes. The group's padding counts
nothing."""
from __future__ import annotations

from typing import List, Tuple

KERNEL = "linear_f32_kernel"
F32 = 4


def shapes(model) -> List[Tuple[int, int]]:
    """``(K, N)`` of one layer's launches, in the prefill's order."""
    d, hd = model["d_model"], model["head_dim"]
    q, kv = model["num_heads"] * hd, model["num_kv_heads"] * hd
    out = [(d, q), (d, kv), (d, kv), (q, d)]
    if model["family"] != "moe":
        ff = model["d_ff"]
        out += [(d, ff)] * (2 if model.get("act", "swiglu") == "swiglu"
                            else 1) + [(ff, d)]
    return out


def launch(rows: int, k: int, n: int) -> Tuple[float, float]:
    return 2.0 * rows * k * n, float(F32 * (rows * k + k * n + rows * n))


def launches(ctx) -> List[Tuple[float, float]]:
    out = []
    for st in ctx.trace_steps:
        if st.prefill_lens:
            rows = sum(st.prefill_lens)
            out += ([launch(rows, k, n) for k, n in shapes(ctx.model)]
                    * ctx.model["num_layers"])
    return out
