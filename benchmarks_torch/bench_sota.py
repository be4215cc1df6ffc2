"""Paper Fig. 8: Libra vs Copier at low (2) and high (8) concurrency.

The port's ``benchmarks/bench_sota.py``: the same rows, concurrencies and
contexts on the port's engines (the full ``libra-proxy-125m`` in full
mode). Speedups normalised to the standard stack, as in the paper. The
paper's Copier collapse at 64 connections is kernel-thread lock
contention; the Copier analogue has no shared lock, so its speedup
saturates instead of collapsing, and the Libra-vs-Copier gap still widens
with concurrency because Copier remains O(payload)::

    PYTHONPATH=src python -m benchmarks_torch.bench_sota
"""
from __future__ import annotations

from benchmarks_torch.common import bench_args, csv, prompts_for, \
    proxy_model, run_engine
from repro_torch.serving.engine import CopierEngine, LibraEngine, \
    StandardEngine


def run(device="cuda") -> dict:
    """``{row name: {engine: (tokens generated, seconds)}}``: each
    concurrency and context of Fig. 8 through the three engines."""
    cfg, model, params = proxy_model(device=device)
    out = {}
    for conc in (2, 8):
        for ctx in (32, 128, 320):
            prompts = prompts_for(cfg.vocab_size, conc, ctx)
            gen = 8
            rows = out[f"fig8_conc{conc}_ctx{ctx}"] = {}
            for name, cls, kw in (
                ("standard", StandardEngine, {}),
                ("copier", CopierEngine, {}),
                ("libra", LibraEngine, dict(page_size=8)),
            ):
                eng, dt = run_engine(cls, model, params, prompts, gen,
                                     max_batch=conc, max_len=ctx + gen + 8,
                                     device=device, **kw)
                rows[name] = (eng.throughput_tokens(), dt)
    return out


def main(argv=None) -> None:
    device = bench_args(argv, __doc__).device
    for row, engines in run(device).items():
        tput = {name: toks / dt for name, (toks, dt) in engines.items()}
        csv(row, 0.0,
            f"libra_speedup={tput['libra']/tput['standard']:.2f} "
            f"copier_speedup={tput['copier']/tput['standard']:.2f}")


if __name__ == "__main__":
    main()
