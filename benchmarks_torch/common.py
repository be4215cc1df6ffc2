"""Shared benchmark utilities of the port's benches.

The part of ``benchmarks/common.py`` the port's benches use so far: the
smoke switch, the CSV line and the machine-readable ``BENCH_<name>.json``
rows. Artifacts go to ``results/bench_torch/`` (:data:`OUT_DIR`), never to
``results/bench/``, whose files belong to the JAX package.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import List, Optional

#: where the port's benches write their artifacts
OUT_DIR = str(Path(__file__).resolve().parents[1] / "results" / "bench_torch")


def is_smoke() -> bool:
    """``LIBRA_BENCH_SMOKE=1``: reduced sizes, a seconds-long gate."""
    return os.environ.get("LIBRA_BENCH_SMOKE", "") == "1"


_ARTIFACT_ROWS: List[dict] = []


def record(name: str, **fields) -> None:
    """Add a structured result row for the running bench; every
    :func:`csv` line is recorded too."""
    _ARTIFACT_ROWS.append({"name": name, **fields})


def flush_artifact(bench: str, out_dir: str = OUT_DIR) -> Optional[str]:
    """Write (and clear) the collected rows as ``BENCH_<bench>.json``.
    Returns the path, or None when the bench recorded nothing."""
    global _ARTIFACT_ROWS
    rows, _ARTIFACT_ROWS = _ARTIFACT_ROWS, []
    if not rows:
        return None
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"BENCH_{bench}.json")
    with open(path, "w") as f:
        json.dump({"bench": bench, "unix_time": time.time(),
                   "smoke": is_smoke(), "rows": rows},
                  f, indent=1, default=str)
    return path


def csv(name: str, us: float, derived: str) -> None:
    print(f"{name},{us:.1f},{derived}")
    record(name, us_per_call=float(us), derived=derived)
