"""``kernels/csrc/paged_attention.cu``'s share of its roofline over the
window's decode steps (``work/paged_attention.py``)."""
from perfbench.metrics import roofline


def read(ctx):
    return roofline(ctx, "paged_attention")
