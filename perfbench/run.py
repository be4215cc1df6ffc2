"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a profiled window. The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number that decided
``correct`` beside its limit); the compared numbers are also the last
lines of standard error. The run exits with 3, printing no result, where
no CUDA device or too few are present, and with 4 where the process has
loaded JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# every cache the program or its libraries keep lives in the checkout, at
# a fixed path, so that only a checkout's first run builds
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT / "src"))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Top-level names of the loaded modules (or of ``names``) that the run
    may not load, compared whole (``repro_torch`` is not ``repro``)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip().splitlines()[0] if res.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness, judge

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        harness.log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    cell = cells[args.workload]

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        harness.log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                    f"{torch.cuda.device_count()} present")
        return 3
    card = power_limit()
    harness.log(f"card: {card}")
    config = harness.load_json("configs", cell["config"])
    mix = harness.load_json("traffic", cell["traffic"])
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = [m["name"] for m in spec[kind]
               if args.workload in m.get("workloads", [args.workload])]
    out = harness.serve(config, mix, args.seed, args.seconds,
                        trace=bool(args.trace), device="cuda",
                        metrics=metrics, clock=harness.process_age)

    bad = forbidden_modules()
    if bad:
        harness.log(f"the run loaded {bad}: no result")
        return 4
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]),
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["trace_window_s"]
    result = {"correct": judge.correct(out["compared"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": {k: {"value": v, "unit": units[k]}
                          for k, v in out["metrics"].items() if k in metrics},
              "device": device,
              "card": card,
              # what the window held, for a look at what the numbers rest on
              "window": {k: out[k] for k in (
                  "window_s", "steps", "tokens", "itl_gaps", "step_ms",
                  "host_cpu_s", "pool", "setup_phases")}}
    if args.trace:
        result["breakdown"] = out["breakdown"]
    result["compared"] = out["compared"]
    for name, c in out["compared"].items():
        harness.log(f"{name}: {c['value']!r} limit {c['limit']!r} "
                    f"({c['tokens']} tokens of {c['requests']} requests)")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
