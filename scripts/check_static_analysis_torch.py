#!/usr/bin/env python
"""CI gate for the port's datapath verifier (``repro_torch.analysis``).

The counterpart of ``scripts/check_static_analysis.py``. Runs the passes —
page/grant ownership lint, kernel audit, cluster-plane lockset check, the
concurrency verifier (lock order, atomicity, steal path), and the
import-graph hygiene check — and fails on any unwaived finding. The kernel
audit runs the CUDA kernels when a CUDA device is present; without one it
runs their plain versions on the CPU (``--device cpu``: ``KERN001``, the
launch count, is then not run) and says so. A wall-clock budget keeps the
gate honest: static analysis that takes minutes stops being run, so the
whole suite must finish in under 30 s.

Usage: python scripts/check_static_analysis_torch.py
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

WALL_BUDGET_S = 30.0


def main() -> int:
    t0 = time.monotonic()
    import torch

    from repro_torch.analysis.__main__ import main as analysis

    device = "cuda" if torch.cuda.is_available() else "cpu"
    if device == "cpu":
        print("no CUDA device: the kernel audit runs the plain versions on "
              "the CPU (--device cpu); KERN001 is not run")
    failed = analysis(["--device", device]) != 0

    wall = time.monotonic() - t0
    print(f"static analysis wall clock: {wall:.1f}s "
          f"(budget {WALL_BUDGET_S:.0f}s)")
    if wall > WALL_BUDGET_S:
        print("FAIL: static analysis exceeded its wall-clock budget — "
              "a slow gate is a skipped gate; profile the offending pass")
        failed = True

    if failed:
        print("check_static_analysis_torch: FAIL")
        return 1
    print("check_static_analysis_torch: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
