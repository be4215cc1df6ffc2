"""Cluster-level fault-tolerance utilities (design + host-side mechanisms).

A copy of the JAX package's ``repro.distributed.fault_tolerance``, which
is Python only. In the port the elastic re-mesh and the compressed
cross-pod reduction wait for a device mesh (``ROADMAP.md``, queue 1, item
5); the monitor and the plan below work on their own.

What runs here vs. what the cluster controller owns:

* **Preemption / checkpoint-restart** — implemented: signal-triggered final
  checkpoint (``Trainer.install_signal_handlers``) + atomic-commit checkpoints +
  exact pipeline resume. At 1000+ nodes the same protocol is driven by the
  cluster scheduler's preemption notice (SIGTERM with a grace window).
* **Elastic re-mesh** — implemented: checkpoints are mesh-agnostic; restore
  recomputes shardings for the surviving mesh (e.g. 2-pod 512 -> 1-pod 256
  after a pod loss) and re-places leaves. Batch size/LR rescaling policy is
  the caller's (examples/train_driver.py shows halving global batch).
* **Straggler mitigation** — implemented: rolling-median step-time deadline
  (Trainer); this module adds the *slice-level* monitor that decides between
  (a) tolerating, (b) excluding a slow pod from the 'pod' axis at the next
  re-mesh, (c) requesting a hot-spare swap. On real fleets the signal comes
  from per-host step barriers; here it is fed by step timings.
* **Gradient compression** — int8 + error feedback over the cross-pod axis
  (the JAX package's ``compressed_psum``): DCI bandwidth is ~4x scarcer
  than ICI, and DP gradients are the only cross-pod traffic in our layout.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional


@dataclasses.dataclass
class SliceHealth:
    slice_id: int
    step_times: List[float] = dataclasses.field(default_factory=list)
    missed_barriers: int = 0
    excluded: bool = False


class StragglerMonitor:
    """Tracks per-slice (pod) step times; flags slices whose rolling median
    exceeds ``factor`` x the fleet median for ``patience`` windows."""

    def __init__(self, n_slices: int, factor: float = 1.5, patience: int = 3,
                 window: int = 20):
        self.slices = {i: SliceHealth(i) for i in range(n_slices)}
        self.factor = factor
        self.patience = patience
        self.window = window
        self._strikes: Dict[int, int] = {i: 0 for i in range(n_slices)}

    def record(self, slice_id: int, step_time: float) -> None:
        h = self.slices[slice_id]
        h.step_times.append(step_time)
        if len(h.step_times) > self.window:
            h.step_times.pop(0)

    def fleet_median(self) -> float:
        times = [t for h in self.slices.values() if not h.excluded
                 for t in h.step_times]
        return statistics.median(times) if times else 0.0

    def evaluate(self) -> List[int]:
        """Returns slice ids recommended for exclusion at the next re-mesh."""
        fleet = self.fleet_median()
        out = []
        if fleet <= 0:
            return out
        for sid, h in self.slices.items():
            if h.excluded or len(h.step_times) < 5:
                continue
            med = statistics.median(h.step_times)
            if med > self.factor * fleet:
                self._strikes[sid] += 1
            else:
                self._strikes[sid] = 0
            if self._strikes[sid] >= self.patience:
                out.append(sid)
        return out

    def exclude(self, slice_id: int) -> None:
        self.slices[slice_id].excluded = True


@dataclasses.dataclass
class ElasticPlan:
    """Re-mesh decision after slice loss/exclusion."""
    surviving_pods: int
    mesh_shape: tuple
    global_batch_scale: float
    lr_scale: float


def plan_elastic_restart(total_pods: int, lost_pods: int,
                         keep_batch: bool = False) -> ElasticPlan:
    """Degrade the 'pod' axis, keeping the within-pod (data, model) layout.
    Linear-scaling rule for LR when the global batch shrinks."""
    surviving = total_pods - lost_pods
    assert surviving >= 1, "no surviving pods"
    scale = 1.0 if keep_batch else surviving / total_pods
    shape = (surviving, 16, 16) if surviving > 1 else (16, 16)
    return ElasticPlan(surviving, shape, scale, scale)
