"""The share, in %, of the engine's paged KV pool that requests hold: the
pages reserved at admission (prompt and every output token a request may
still take) over the pool's pages, after each step of the measured window,
averaged over its steps. It says how much of ``memory_peak_bytes`` the
traffic fills."""


def read(ctx):
    if not ctx.steps:
        return None
    return 100.0 * sum(st.pool_used for st in ctx.steps) / len(ctx.steps)
