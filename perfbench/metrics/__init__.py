"""Per-layer metric readers: ``metrics/<name>.py`` gives ``read(ctx)``, the
metric's value from the traced run's steps, spans, counters and trace
(``harness.Context``), or ``None`` where it finds nothing to read; the
harness then leaves the metric out of the result."""
from __future__ import annotations

import sys
from typing import Optional


def roofline(ctx, kernel: str) -> Optional[float]:
    """The share, in %, of the window's time in ``kernel`` that its bound
    takes: for each launch the larger of its bytes over the peak bandwidth
    and its operations over the peak TF32 rate (``work/<kernel>.py``),
    summed, over the summed kernel time from the trace."""
    work = ctx.work(kernel)
    counted = work.launches(ctx)
    n, seconds = ctx.trace.kernel_seconds(work.KERNEL)
    if not counted or seconds <= 0:
        return None
    if n != len(counted):
        print(f"{kernel}: the trace holds {n} launches and the steps "
              f"{len(counted)}: no share", file=sys.stderr)
        return None
    bw, peak = ctx.peaks["hbm_bytes_per_s"], ctx.peaks["tf32_flops_per_s"]
    bound = sum(max(b / bw, f / peak) for f, b in counted)
    return 100.0 * bound / seconds
