"""How much the profiler slows the host: the profiled window's mean
``decode_step`` span over the measured window's, whose run had no
profiler. ``device_idle_pct`` is read under the profiler; this says by how
much its window's host work was stretched."""


def read(ctx):
    def mean(steps):
        calls = [st.decode_s for st in steps if st.decode_ctx]
        return sum(calls) / len(calls) if calls else 0.0

    plain, profiled = mean(ctx.steps), mean(ctx.trace_steps)
    if plain <= 0 or profiled <= 0:
        return None
    return profiled / plain
