"""Reading the profiler's trace of a measured window.

The window runs under ``torch.profiler`` (CPU and CUDA activities) inside a
``bench.window`` label; the benchmark's own labels ``bench.step``,
``bench.prefill`` and ``bench.decode`` mark the calls into the engine and
the model. The trace is exported as Chrome JSON into the run's temporary
directory, read back and deleted. :func:`summarise` reduces it to what the
metric readers and the result's ``breakdown`` need: the window's length,
the device's busy intervals (their union), each kernel launch's name and
time, and the idle gaps by the label and host operation they fell in.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
LABELS = ("bench.step", "bench.prefill", "bench.decode")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    #: (name, seconds) of every device operation inside the window
    ops: List[Tuple[str, float]] = field(default_factory=list)
    #: idle seconds by "label:host operation"
    idle_by: Dict[str, float] = field(default_factory=dict)

    def kernel_seconds(self, needle: str) -> Tuple[int, float]:
        """Launches and seconds of the kernels whose name holds ``needle``."""
        hits = [s for n, s in self.ops if needle in n]
        return len(hits), sum(hits)

    def breakdown(self, n: int = 10) -> Dict:
        by: Dict[str, float] = {}
        for name, s in self.ops:
            key = name[:96]
            by[key] = by.get(key, 0.0) + s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_by.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def export(prof) -> List[Dict]:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _innermost(intervals: List[Tuple[float, float, str]],
               points: List[float]) -> List[str]:
    """For each of the sorted ``points``, the name of the shortest of the
    properly nested ``intervals`` that holds it ("" where none does)."""
    order = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    stack: List[Tuple[float, float, str]] = []
    out, i = [], 0
    for p in points:
        while i < len(order) and order[i][0] <= p:
            while stack and stack[-1][1] <= order[i][0]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else "")
    return out


def summarise(events: List[Dict]) -> TraceSummary:
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} windows, not 1")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    tid = win[0].get("tid")
    dev = []
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        if b <= w0 or a >= w1:
            continue
        a, b = max(a, w0), min(b, w1)
        dev.append((a, b))
        ops.append((e["name"], (b - a) / 1e6))
    busy = _union(dev)
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if w1 > prev:
        gaps.append((prev, w1))
    mids = [(a + b) / 2 for a, b in gaps]
    host = [e for e in events if e.get("ph") == "X" and e.get("tid") == tid
            and e.get("cat") in ("cpu_op", "user_annotation")
            and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    labels = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][6:])
              for e in host if e["name"] in LABELS]
    cpu = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
           for e in host if e.get("cat") == "cpu_op"]
    idle: Dict[str, float] = {}
    for (a, b), lab, op in zip(gaps, _innermost(labels, mids),
                               _innermost(cpu, mids)):
        key = f"{lab or 'loop'}:{op or 'python'}"
        idle[key] = idle.get(key, 0.0) + (b - a) / 1e6
    return TraceSummary(window_s=(w1 - w0) / 1e6,
                        busy_s=sum(b - a for a, b in busy) / 1e6,
                        ops=ops, idle_by=idle)
