"""``kernels/csrc/linear_f32.cu``'s share of its roofline over the window's
prefills (``work/linear_f32.py``). It takes each float32 product as three
TF32 products, so it reads at most a third of the TF32 roofline. A run
whose trace holds no such kernel reads nothing."""
from perfbench.metrics import roofline


def read(ctx):
    return roofline(ctx, "linear_f32")
