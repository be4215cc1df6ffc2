"""Paper Fig. 6e: single-stream latency + host-work share.

The port's ``benchmarks/bench_single_stream.py``: the same rows. Stream
level (socket facade): one client-backend flow per payload size (in full
mode on a :data:`common.DEPLOYMENT` stack and header); Libra's
user-boundary work is metadata-sized while the full-copy path scales with
the payload. Engine level (full mode; the full ``libra-proxy-125m``):
end-to-end latency is expected to be comparable (dominated by model
compute); the win shows in host-boundary work per request::

    PYTHONPATH=src python -m benchmarks_torch.bench_single_stream
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


def stream_section(device="cuda") -> None:
    n_msgs = 8
    geo = dict({"pages": 4096}, **stream_kw())
    for payload in (64, 512, 4096):
        rows = {}
        for name, selective in (("libra", True), ("fullcopy", False)):
            stack, rt, msgs, dt = run_stream(
                n_conns=1, n_msgs=n_msgs, payload=payload,
                parsers=["length-prefixed"], selective=selective,
                device=device, **geo)
            rows[name] = (dt, stack.counters.total_user_copies())
        (t_l, cp_l), (t_s, cp_s) = rows["libra"], rows["fullcopy"]
        csv(f"fig6e_stream_p{payload}_latency", t_l * 1e6 / n_msgs,
            f"libra_s={t_l:.4f} fullcopy_s={t_s:.4f}")
        csv(f"fig6e_stream_p{payload}_boundary_tokens", 0.0,
            f"libra={cp_l} fullcopy={cp_s} ratio={cp_s/max(cp_l,1):.1f}x")


def engine_section(device="cuda") -> None:
    from repro_torch.serving.engine import LibraEngine, StandardEngine

    cfg, model, params = proxy_model(device=device)
    for ctx in (32, 128, 320):
        prompts = prompts_for(cfg.vocab_size, 1, ctx)
        libra, t_l = run_engine(LibraEngine, model, params, prompts, 8,
                                max_batch=1, max_len=ctx + 16, page_size=8,
                                device=device)
        std, t_s = run_engine(StandardEngine, model, params, prompts, 8,
                              max_batch=1, max_len=ctx + 16, device=device)
        csv(f"fig6e_ctx{ctx}_latency", t_l * 1e6,
            f"libra_s={t_l:.3f} std_s={t_s:.3f} ratio={t_l/t_s:.2f}")
        csv(f"fig6e_ctx{ctx}_boundary_bytes", 0.0,
            f"libra={libra.stats.d2h_bytes + libra.stats.h2d_bytes} "
            f"std={std.stats.d2h_bytes + std.stats.h2d_bytes}")


def main(argv=None) -> None:
    device = bench_args(argv, __doc__).device
    stream_section(device)
    if not is_smoke():
        engine_section(device)


if __name__ == "__main__":
    main()
