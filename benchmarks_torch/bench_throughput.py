"""Paper Fig. 6a/6b: throughput and P99 latency vs payload size for the four
stacks (Libra / Standard / Copier / Static-aka-F-Stack).

The port's ``benchmarks/bench_throughput.py``: the same rows, contexts and
engines, on the port's engines (``flash_attention`` in every prefill,
``paged_attention`` in Libra's decode; the full ``libra-proxy-125m`` in
full mode). Payload size maps to context length; the Static engine gets
a fixed memory budget, so its attainable concurrency collapses as
payloads grow (the paper's F-Stack large-payload inversion).

A stream-level preamble reports the same sweep through the socket facade
with one proxied flow per request (in full mode on a
:data:`common.DEPLOYMENT` stack and header)::

    PYTHONPATH=src python -m benchmarks_torch.bench_throughput
"""
from __future__ import annotations

from benchmarks_torch.common import (
    bench_args,
    csv,
    is_smoke,
    prompts_for,
    proxy_model,
    run_engine,
    run_stream,
    stream_kw,
)
from repro_torch.serving.engine import (
    CopierEngine,
    LibraEngine,
    StandardEngine,
    StaticEngine,
)

CTX_SIZES = (16, 64, 160, 320)
N_REQ = 8
GEN = 8
BUDGET = 26_000_000  # bytes: fits ~8 slots at ctx 64 but ~1 at ctx 320


def stream_preamble(device="cuda") -> None:
    for ctx in CTX_SIZES:
        rows = {}
        for name, selective in (("libra", True), ("fullcopy", False)):
            stack, rt, msgs, dt = run_stream(
                n_conns=N_REQ, n_msgs=4, payload=ctx * 8,
                selective=selective, device=device, **stream_kw())
            rows[name] = (msgs / max(dt, 1e-9),
                          stack.counters.total_user_copies())
        (tput, cp), (_, cp_full) = rows["libra"], rows["fullcopy"]
        csv(f"fig6a_stream_ctx{ctx}", 1e6 / max(tput, 1e-9),
            f"msgs_per_s={tput:.0f} "
            f"boundary_tokens={cp} vs_fullcopy={cp_full} "
            f"copy_reduction={cp_full/max(cp,1):.1f}x")


def main(argv=None) -> None:
    device = bench_args(argv, __doc__).device
    stream_preamble(device)
    if is_smoke():
        return
    cfg, model, params = proxy_model(device=device)
    for ctx in CTX_SIZES:
        max_len = ctx + GEN + 8
        prompts = prompts_for(cfg.vocab_size, N_REQ, ctx)
        rows = {}
        for name, cls, kw in (
            ("libra", LibraEngine, dict(max_batch=8, page_size=8)),
            ("standard", StandardEngine, dict(max_batch=8)),
            ("copier", CopierEngine, dict(max_batch=8)),
            ("static", StaticEngine, dict(memory_budget=BUDGET)),
        ):
            eng, dt = run_engine(cls, model, params, prompts, GEN,
                                 max_len=max_len, device=device, **kw)
            rows[name] = (eng.throughput_tokens() / dt, eng.p99_latency(),
                          eng.max_batch)
        base = rows["standard"][0]
        for name, (tput, p99, b) in rows.items():
            csv(f"fig6_ctx{ctx}_{name}", 1e6 / max(tput, 1e-9),
                f"tok/s={tput:.1f} speedup={tput/base:.2f} "
                f"p99_ms={p99*1000:.1f} batch={b}")


if __name__ == "__main__":
    main()
