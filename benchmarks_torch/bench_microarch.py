"""Paper Fig. 9: micro-architectural efficiency breakdown.

The port's ``benchmarks/bench_microarch.py``: the same rows and contexts
on the port's engines (the full ``libra-proxy-125m`` in full mode).

9a (dTLB) analogue: anchored pages are touched exactly once (write) plus
streamed reads; the standard stack's cache is rewritten wholesale every
step. Reported as bytes touched per useful byte, the locality proxy.
9b: cost breakdown by category (Std Copy / Std Alloc / Meta Sel-Copy /
Meta Alloc / Meta SKB-Trans analogues) from engine counters.
9c: data processed per unit of host-boundary work::

    PYTHONPATH=src python -m benchmarks_torch.bench_microarch
"""
from __future__ import annotations

from benchmarks_torch.common import bench_args, csv, prompts_for, \
    proxy_model, run_engine
from repro_torch.serving.engine import LibraEngine, StandardEngine


def main(argv=None) -> None:
    device = bench_args(argv, __doc__).device
    cfg, model, params = proxy_model(device=device)
    for ctx in (32, 128, 320):
        prompts = prompts_for(cfg.vocab_size, 4, ctx)
        gen = 8
        libra, t_l = run_engine(LibraEngine, model, params, prompts, gen,
                                max_batch=4, max_len=ctx + gen + 8,
                                page_size=8, device=device)
        std, t_s = run_engine(StandardEngine, model, params, prompts, gen,
                              max_batch=4, max_len=ctx + gen + 8,
                              device=device)
        l, s = libra.stats, std.stats
        useful = l.anchored_bytes  # payload bytes the workload actually needs
        libra_touch = l.anchored_bytes + l.h2d_bytes + l.d2h_bytes
        std_touch = s.payload_copy_bytes + s.h2d_bytes + s.d2h_bytes
        csv(f"fig9a_ctx{ctx}_locality", 0.0,
            f"libra_touch_per_useful={libra_touch/max(useful,1):.2f} "
            f"std_touch_per_useful={std_touch/max(useful,1):.2f}")
        csv(f"fig9b_ctx{ctx}_libra", 0.0,
            f"sel_copy={l.h2d_bytes} meta_alloc={l.alloc_events} "
            f"skb_trans={l.zero_copy_bytes} anchored={l.anchored_bytes}")
        csv(f"fig9b_ctx{ctx}_std", 0.0,
            f"std_copy={s.payload_copy_bytes} std_alloc={s.alloc_events} "
            f"logits_d2h={s.d2h_bytes}")
        csv(f"fig9c_ctx{ctx}_efficiency", 0.0,
            f"libra_bytes_per_boundary_byte="
            f"{useful/max(l.h2d_bytes + l.d2h_bytes, 1):.1f} "
            f"std={s.payload_copy_bytes/max(s.h2d_bytes + s.d2h_bytes, 1):.1f}")


if __name__ == "__main__":
    main()
