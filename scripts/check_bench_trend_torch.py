#!/usr/bin/env python
"""Benchmark trend gate of the port: diff fresh
``results/bench_torch/BENCH_*.json`` against the committed (git HEAD)
baselines and FAIL on a throughput regression.

The port's ``scripts/check_bench_trend.py``: the same metrics, tolerance,
confirmation re-run and warn-only cases, over the port's artifacts.

For every artifact present in the working tree, the committed version is
read via ``git show HEAD:<path>``. Rows are matched by ``name``; every
shared throughput metric (``msgs_per_s``, ``rounds_per_s``, and the kTLS
``hw_over_sw``/``hw_fused_over_sw`` ratios) must not drop
below ``(1 - tolerance)`` of its baseline (default tolerance 30%, i.e. a
>30% regression fails — override with ``LIBRA_TREND_TOLERANCE``).

Throughput samples on a shared box are noisy; a one-off slow sample must
not fail the build. When a metric trips, the gate **re-runs that one
benchmark module** (``python -m benchmarks_torch.run [--smoke] --only
<bench> --device <device> --out <dir>``, refreshing its artifact) and
re-compares: a metric only FAILS if the regression persists on the
confirmation run; a recovered metric is reported as noise.

Warn-only cases (never fail):
  * no committed baseline for an artifact (a brand-new benchmark),
  * baseline and fresh run disagree on smoke mode (different regimes),
  * a row/metric present on only one side.

Exit status: 0 = ok (possibly with warnings), 1 = at least one confirmed
regression.

  PYTHONPATH=src python scripts/check_bench_trend_torch.py \\
      [--dir results/bench_torch] [--device cuda]

The confirmation re-run runs on ``--device`` (``cuda`` by default, as the
baselines were measured on the card).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

METRICS = ("msgs_per_s", "rounds_per_s", "hw_over_sw", "hw_fused_over_sw")


def _baseline(repo: str, relpath: str):
    """The committed (HEAD) version of ``relpath``, or None."""
    try:
        out = subprocess.run(
            ["git", "show", f"HEAD:{relpath}"], cwd=repo,
            capture_output=True, check=True)
        return json.loads(out.stdout)
    except (subprocess.CalledProcessError, json.JSONDecodeError,
            FileNotFoundError):
        return None


def _rows_by_name(doc) -> dict:
    return {r["name"]: r for r in doc.get("rows", []) if "name" in r}


def _rerun_bench(repo: str, bench_dir: str, bench: str, smoke: bool,
                 device: str) -> bool:
    """Confirmation run for one benchmark module (refreshes its artifact).
    Returns False when the re-run itself failed."""
    cmd = [sys.executable, "-m", "benchmarks_torch.run", "--only", bench,
           "--device", device, "--out", os.path.join(repo, bench_dir)]
    if smoke:
        cmd.append("--smoke")
    env = dict(os.environ)
    paths = [os.path.join(repo, "src"), repo]
    prev = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = os.pathsep.join(paths + ([prev] if prev else []))
    try:
        subprocess.run(cmd, cwd=repo, env=env, check=True,
                       capture_output=True, timeout=600)
        return True
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return False


def _compare(rel: str, base: dict, fresh: dict, tolerance: float):
    """(failing, warnings, checked) for one artifact pair."""
    failing, warnings, checked = [], [], 0
    brows, frows = _rows_by_name(base), _rows_by_name(fresh)
    for name, brow in brows.items():
        frow = frows.get(name)
        if frow is None:
            warnings.append(f"{rel}: row '{name}' vanished")
            continue
        for m in METRICS:
            if m not in brow:
                continue
            if m not in frow:
                warnings.append(f"{rel}: {name}.{m} vanished")
                continue
            b, f = float(brow[m]), float(frow[m])
            if b <= 0:
                continue
            checked += 1
            ratio = f / b
            if ratio < 1.0 - tolerance:
                failing.append(
                    f"{name}.{m} {b:.0f} -> {f:.0f} "
                    f"({(1 - ratio) * 100:.0f}% regression)")
    return failing, warnings, checked


def check(repo: str, bench_dir: str, tolerance: float,
          device: str = "cuda"):
    regressions, warnings, checked = [], [], 0
    for path in sorted(glob.glob(os.path.join(repo, bench_dir,
                                              "BENCH_*.json"))):
        rel = os.path.relpath(path, repo)
        fresh = json.load(open(path))
        base = _baseline(repo, rel)
        if base is None:
            warnings.append(f"{rel}: no committed baseline (new benchmark)")
            continue
        if bool(fresh.get("smoke")) != bool(base.get("smoke")):
            warnings.append(f"{rel}: smoke-mode mismatch vs baseline "
                            f"(fresh={fresh.get('smoke')}, "
                            f"base={base.get('smoke')}) — skipped")
            continue
        failing, warns, n = _compare(rel, base, fresh, tolerance)
        warnings += warns
        checked += n
        if failing:
            # noisy-sample guard: confirm on a fresh run of just this
            # module before failing the build
            bench = fresh.get("bench", "")
            print(f"RETRY {rel}: {len(failing)} metric(s) tripped — "
                  f"re-running '{bench}' to confirm", flush=True)
            if bench and _rerun_bench(repo, bench_dir, bench,
                                      bool(fresh.get("smoke")), device):
                fresh2 = json.load(open(path))
                confirmed, _, _ = _compare(rel, base, fresh2, tolerance)
                for msg in failing:
                    if not any(c.split(" ")[0] == msg.split(" ")[0]
                               for c in confirmed):
                        warnings.append(
                            f"{rel}: {msg} — recovered on re-run (noise)")
                failing = confirmed
            regressions += [f"{rel}: {msg}" for msg in failing]
    return regressions, warnings, checked


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join("results", "bench_torch"))
    ap.add_argument("--tolerance", type=float,
                    default=float(os.environ.get("LIBRA_TREND_TOLERANCE",
                                                 "0.30")))
    ap.add_argument("--device", default="cuda",
                    help="where the confirmation re-run runs")
    args = ap.parse_args(argv)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    regressions, warnings, checked = check(repo, args.dir, args.tolerance,
                                           args.device)
    for w in warnings:
        print(f"WARN  {w}")
    for r in regressions:
        print(f"FAIL  {r}")
    print(f"bench-trend: {checked} metric(s) checked, "
          f"{len(regressions)} regression(s), {len(warnings)} warning(s) "
          f"(tolerance {args.tolerance:.0%})")
    return 1 if regressions else 0


if __name__ == "__main__":
    raise SystemExit(main())
