"""The share, in %, of the traced window in which no operation runs on the
device: one less the union of the trace's device intervals over the
window."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
