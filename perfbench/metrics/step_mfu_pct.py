"""The whole step's share, in %, of the card's peak: the model operations
of the measured window's prompt and output tokens (``work/model.py``) over
the window's seconds on the host's clock (no profiler runs in it) and the
peak TF32 rate."""
from perfbench.work import model as work


def read(ctx):
    m = ctx.model
    flops = 0.0
    for st in ctx.steps:
        for n in st.prefill_lens:
            flops += sum(work.token_flops(m, i + 1) for i in range(n))
        flops += sum(work.token_flops(m, c) for c in st.decode_ctx)
    flops += ctx.tokens * work.head_flops(m)
    if flops <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * flops / ctx.window_s / ctx.peaks["tf32_flops_per_s"]
