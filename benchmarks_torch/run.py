"""Benchmark harness of the port: one module per paper table or figure.

The port's ``benchmarks/run.py``. Prints ``name,us_per_call,derived`` CSV
lines per bench and writes each module's rows to
``results/bench_torch/BENCH_<name>.json`` (or ``--out``). A bench that
raises writes an ``ERROR`` row into its artifact, and the run exits
non-zero. ``--device`` is ``cuda`` by default (the kernels are built
before the first bench; with no card the run raises) and ``cpu`` only
when asked; ``--smoke`` runs :data:`SMOKE_BENCHES` at the reference's
reduced sizes (``LIBRA_BENCH_SMOKE=1``). Committing the refreshed
artifacts with a change is the convention: they are the trajectory that
``scripts/check_bench_trend_torch.py`` gates::

    PYTHONPATH=src python -m benchmarks_torch.run [--smoke] [--only fig6]
    LIBRA_BENCH_SMOKE=1 PYTHONPATH=src python -m benchmarks_torch.run \\
        --smoke --device cpu

After the benches (unless ``--smoke``, or ``--only`` names another bench)
it prints the roofline summary of the port's dry-run artifacts
(``results/dryrun_torch/``, written by ``repro_torch.launch.dryrun``), as
the reference's does of its own; ``--only roofline`` prints only that.
"""
from __future__ import annotations

import argparse
import glob
import importlib
import json
import os
import time
from typing import Optional, Sequence

from benchmarks_torch import common

BENCHES = [
    ("fig1_copy_overhead", "benchmarks_torch.bench_copy_overhead"),
    ("fig6_throughput_latency", "benchmarks_torch.bench_throughput"),
    ("fig6_stream_proxy", "benchmarks_torch.bench_proxy_runtime"),
    ("batched_datapath", "benchmarks_torch.bench_batched_datapath"),
    ("dma_overlap", "benchmarks_torch.bench_dma_overlap"),
    ("cluster_proxy", "benchmarks_torch.bench_cluster_proxy"),
    ("fig6c_ktls", "benchmarks_torch.bench_ktls_analogue"),
    ("fig6cd_ktls_proxy", "benchmarks_torch.bench_ktls_proxy"),
    ("policy_proxy", "benchmarks_torch.bench_policy_proxy"),
    ("chaos_proxy", "benchmarks_torch.bench_chaos_proxy"),
    ("fig6e_single_stream", "benchmarks_torch.bench_single_stream"),
    ("fig8_vs_copier", "benchmarks_torch.bench_sota"),
    ("fig9_microarch", "benchmarks_torch.bench_microarch"),
]

# --smoke: the stream-level benches plus the encrypted-datapath gate (a
# reduced LibraEngine sharing the proxy stack)
SMOKE_BENCHES = [
    ("fig1_copy_overhead", "benchmarks_torch.bench_copy_overhead"),
    ("fig6_throughput_latency", "benchmarks_torch.bench_throughput"),
    ("fig6_stream_proxy", "benchmarks_torch.bench_proxy_runtime"),
    ("batched_datapath", "benchmarks_torch.bench_batched_datapath"),
    ("dma_overlap", "benchmarks_torch.bench_dma_overlap"),
    ("cluster_proxy", "benchmarks_torch.bench_cluster_proxy"),
    ("fig6cd_ktls_proxy", "benchmarks_torch.bench_ktls_proxy"),
    ("policy_proxy", "benchmarks_torch.bench_policy_proxy"),
    ("chaos_proxy", "benchmarks_torch.bench_chaos_proxy"),
    ("fig6e_single_stream", "benchmarks_torch.bench_single_stream"),
]

def roofline_summary() -> None:
    """Collapse results/dryrun_torch/*.json into the roofline table lines:
    a cell's step time is the largest of its three terms on an H100."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = sorted(glob.glob(os.path.join(here, "results", "dryrun_torch",
                                          "*.json")))
    if not files:
        print("roofline_summary,0.0,no dryrun artifacts "
              "(run repro_torch.launch.dryrun)")
        return
    for f in files:
        with open(f) as fh:
            r = json.load(fh)
        cell = f"{r['arch']}/{r['shape']}/{r['mesh']}"
        if r.get("skipped"):
            print(f"roofline_{cell},0.0,SKIP ({r['reason'][:60]})")
            continue
        if not r.get("ok"):
            print(f"roofline_{cell},0.0,FAIL {r.get('error', '')[:80]}")
            continue
        t = r["roofline"]
        step_s = max(t["compute_s"], t["memory_s"], t["collective_s"])
        print(f"roofline_{cell},{step_s * 1e6:.1f},"
              f"dom={t['dominant']} comp={t['compute_s']:.4f} "
              f"mem={t['memory_s']:.4f} coll={t['collective_s']:.4f} "
              f"useful={t['useful_ratio']:.2f}")


#: the bench that writes its own artifact, so takes the output directory
SELF_FLUSHING = ("dma_overlap",)


def run(benches, *, device: str, out_dir: str,
        only: Optional[str] = None) -> int:
    """Run each ``(name, module)`` of ``benches`` whose name contains
    ``only``, writing ``BENCH_<name>.json`` into ``out_dir``. Returns how
    many benches raised (each wrote an ``ERROR`` row)."""
    common.prepare(device)
    failures = 0
    for name, mod in benches:
        if only and only not in name:
            continue
        print(f"# --- {name} ---", flush=True)
        argv = ["--device", device]
        if name in SELF_FLUSHING:
            argv += ["--out", out_dir]
        t0 = time.time()
        try:
            importlib.import_module(mod).main(argv)
        except Exception as e:  # noqa: BLE001 -- recorded, and fails the run
            failures += 1
            common.record("ERROR", error=f"{type(e).__name__}: {e}")
            print(f"{name},0.0,ERROR {type(e).__name__}: {e}")
        path = (common.flush_artifact(name, out_dir)
                or os.path.join(out_dir, f"BENCH_{name}.json"))
        print(f"# {name} done in {time.time() - t0:.1f}s -> {path}",
              flush=True)
    return failures


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="the stream-level subset at reduced sizes; sets "
                         "LIBRA_BENCH_SMOKE=1")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=common.OUT_DIR)
    args = ap.parse_args(argv)
    benches = BENCHES
    if args.smoke:
        os.environ["LIBRA_BENCH_SMOKE"] = "1"
        benches = SMOKE_BENCHES
    failures = 0
    if any(not args.only or args.only in name for name, _ in benches):
        failures = run(benches, device=args.device, out_dir=args.out,
                       only=args.only)
    if not args.smoke and (not args.only or "roofline" in args.only):
        print("# --- roofline (from dry-run artifacts) ---")
        roofline_summary()
    if failures:
        raise SystemExit(f"{failures} benchmark module(s) errored")


if __name__ == "__main__":
    main()
