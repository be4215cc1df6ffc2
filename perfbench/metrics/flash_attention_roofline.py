"""``kernels/csrc/flash_attention.cu``'s share of its roofline over the
window's prefills (``work/flash_attention.py``)."""
from perfbench.metrics import roofline


def read(ctx):
    return roofline(ctx, "flash_attention")
