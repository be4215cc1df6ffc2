"""``kernels/csrc/moe_experts.cu``'s share of its roofline over the
window's prefills and decode steps (``work/moe_experts.py``: each launch's
bytes count the routed experts its entries reach, as the port's routing
kernels note them). It takes each float32 product as three TF32 products,
so it reads at most a third of the TF32 roofline where the operations
bound it. A run whose trace holds no such kernel, or whose program notes
no reached experts, reads nothing."""
from perfbench.metrics import roofline


def read(ctx):
    return roofline(ctx, "moe_experts")
