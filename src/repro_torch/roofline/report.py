"""Render the roofline markdown table from the port's dry-run artifacts.

  PYTHONPATH=src python -m repro_torch.roofline.report [--dir results/dryrun_torch]

The terms are seconds a step on one H100 (``roofline/hw``); the counts
behind them are the dry-run's per-device counts on the fake mesh.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

ARCH_ORDER = [
    "phi3-mini-3.8b", "phi4-mini-3.8b", "minicpm-2b", "mistral-nemo-12b",
    "hymba-1.5b", "xlstm-350m", "whisper-medium", "qwen3-moe-30b-a3b",
    "qwen2-moe-a2.7b", "internvl2-76b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(dir_: str) -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def fmt_row(r: Dict) -> str:
    cell = f"{r['arch']} | {r['shape']} | {r['mesh']}"
    if r.get("skipped"):
        return f"| {cell} | — | — | — | — | — | skip (full attention) |"
    if not r.get("ok"):
        return f"| {cell} | — | — | — | — | — | FAIL |"
    t = r["roofline"]
    dom = t["dominant"]
    peak = r["memory"]["peak_estimate_bytes"] / 2 ** 30
    return (f"| {cell} | {t['compute_s']:.4f} | {t['memory_s']:.4f} | "
            f"{t['collective_s']:.4f} | **{dom}** | {t['useful_ratio']:.2f} | "
            f"{peak:.1f} GiB |")


def main() -> None:
    ap = argparse.ArgumentParser()
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--dir", default=os.path.join(here, "results",
                                                  "dryrun_torch"))
    args = ap.parse_args()
    recs = load(args.dir)
    by_key = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}
    print("| arch | shape | mesh | compute s | memory s | collective s "
          "| dominant | useful | peak/device |")
    print("|---|---|---|---|---|---|---|---|---|")
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            for mesh in ("singlepod", "multipod"):
                r = by_key.get((arch, shape, mesh))
                if r:
                    print(fmt_row(r))
    ok = sum(1 for r in recs if r.get("ok") and not r.get("skipped"))
    skip = sum(1 for r in recs if r.get("skipped"))
    fail = sum(1 for r in recs if not r.get("ok"))
    print(f"\ncells: {ok} ran OK, {skip} assignment skips, {fail} failed")


if __name__ == "__main__":
    main()
