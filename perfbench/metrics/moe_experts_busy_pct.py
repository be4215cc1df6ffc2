"""The share, in %, of the profiled window's busy device time that
``kernels/csrc/moe_experts.cu`` takes: its summed kernel time over the
union of the trace's device intervals. A run whose trace holds no such
kernel reads nothing."""
from perfbench.work import moe_experts


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0:
        return None
    n, seconds = t.kernel_seconds(moe_experts.KERNEL)
    if not n:
        return None
    return 100.0 * seconds / t.busy_s
