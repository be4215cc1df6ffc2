"""``kernels/csrc/moe_experts.cu``: the serving paths' MoE experts, one
launch a layer a prefill, over the admission group's real rows (the sum of
its prompt lengths: its padding is not routed), and one a layer a decode
step, over the rows that decode (rows parked on the scratch page count
nothing). Each of ``rows`` goes to ``top_k`` routed experts and to the
shared expert: ``2 (top_k rows) D F`` operations for each of a routed
expert's three products and ``2 rows D (S F)`` for each of the shared
expert's. Bytes: the three matrices of each routed expert that the launch's
entries reach, the shared expert's three, and the rows in and their outputs
out once. The count is the work, whatever implements it: no capacity
slots, no padded experts.

Which experts a launch reaches follows from the routing, which the steps do
not record: the port's routing kernels note it for each call in a ring on
the card (``kernels/moe_experts.experts_reached``), and the profiled
window's launches are the ring's last. A launch's rows need not spread
over the experts, and a served window's do not: they reach far fewer than
``min(E, top_k rows)``, and counting that many a launch puts the bound
above the work. Where the ring cannot be read (no card, or a program
without it) nothing is counted."""
from __future__ import annotations

from typing import List, Optional, Tuple

KERNEL = "moe_experts_kernel"
F32 = 4


def launch(model, rows: int, reached: int) -> Tuple[float, float]:
    """``(flops, bytes)`` of one layer's launch over ``rows`` rows whose
    entries reach ``reached`` routed experts."""
    d, f, k = model["d_model"], model["expert_d_ff"], model["top_k"]
    sf = model["num_shared_experts"] * f
    flops = 3 * 2.0 * (k * rows) * d * f + 3 * 2.0 * rows * d * sf
    weights = 3 * d * f * reached + 3 * d * sf
    return flops, float(F32 * (weights + 2 * rows * d))


def launch_rows(ctx) -> List[int]:
    """The rows of each of the profiled window's launches, in order: a
    step's prefill, then its decode half."""
    layers = ctx.model["num_layers"]
    out: List[int] = []
    for st in ctx.trace_steps:
        if st.prefill_lens:
            out += [sum(st.prefill_lens)] * layers
        if st.decode_ctx:
            out += [len(st.decode_ctx)] * layers
    return out


def reached(n: int) -> Optional[List[int]]:
    """The routed experts of the last ``n`` routing calls, from the
    port's ring; ``None`` where it has none."""
    from repro_torch.kernels import moe_experts

    read = getattr(moe_experts, "experts_reached", None)
    return None if read is None else read(n)


def launches(ctx) -> List[Tuple[float, float]]:
    rows = launch_rows(ctx)
    experts = reached(len(rows)) if rows else None
    if experts is None:
        return []
    return [launch(ctx.model, r, e) for r, e in zip(rows, experts)]
