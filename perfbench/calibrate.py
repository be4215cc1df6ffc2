"""Readings that the limits of ``correct`` are set from, on the chip.

    python3 -m perfbench.calibrate --workload <name> --seconds <s> --seeds <n,n,...>

runs the cell once a seed in one process, at the cell's own load with a
window of ``--seconds``, and prints a JSON line a seed: the program's
reading of each compared number and the control's (the reference put in
the program's place at TF32), on the same sample. The benchmark's own
runs never run the control. PERF.md gives the readings and the limits set
from them.
"""
from __future__ import annotations

import argparse
import json

from perfbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        harness.log("calibration reads the chip: no CUDA device")
        return 3
    spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in spec["workloads"]}[args.workload]
    config = harness.load_json("configs", cell["config"])
    mix = harness.load_json("traffic", cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.serve(config, mix, seed, args.seconds, trace=False,
                            device="cuda", metrics=[], control=True,
                            clock=harness.process_age)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": out["compared"],
                          "control": out["control"],
                          "metrics": out["metrics"],
                          "memory_peak_bytes": out["memory_peak_bytes"]}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
