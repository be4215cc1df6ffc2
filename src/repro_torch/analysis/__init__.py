"""Static-analysis suite for the port's datapath (verifier analogue).

The counterpart of the JAX package's ``repro.analysis``, over the port's
own ``core/`` and kernels. Libra's safety story rests on the eBPF verifier
proving selective-copy programs safe *before* they touch the datapath;
these passes gate the same invariants of ``repro_torch``:

- :mod:`repro_torch.analysis.ownership` — AST dataflow over ``core/*.py``
  modeling the page/grant lifecycle; flags paths where an exception or
  early return escapes between acquire and release without try/finally
  or an explicit ownership handoff.
- :mod:`repro_torch.analysis.kernel_audit` — the counterpart of the jaxpr
  audit, reading each kernel entry as it runs: the declared launches of
  the port's kernels (one per fused round), no pool-sized copy or
  allocation, no silent int64, the declared boundary-element budget, the
  pool updated in place; and :func:`~repro_torch.analysis.kernel_audit.
  audit_rounds`, the same of a whole ``ProxyRuntime.run()`` on the card,
  its boundary bytes held to the pool's ``xfer`` counters.
- :mod:`repro_torch.analysis.lockset` — derives the shared-mutable-state
  map of the cluster plane as a checked manifest, plus a test-time
  ``LocksetMonitor`` that records accessor-worker sets per shared object
  and fails on unsynchronized cross-worker mutation.
- :mod:`repro_torch.analysis.concurrency` — lock order, atomicity and the
  steal path, against a committed lock-hierarchy manifest.
- :mod:`repro_torch.analysis.importgraph` — import-graph hygiene (modules
  under ``src/repro_torch`` unreachable from tests, scripts, examples,
  ``benchmarks_torch`` and ``chip_smoke.py``).

Findings carry ``file:line``, an invariant rule name, and honor waiver
comments of the form ``# libra: waive[RULE] reason`` (reason mandatory).
CLI: ``python -m repro_torch.analysis``. Nothing here imports JAX or the
JAX package.
"""
from repro_torch.analysis.common import Finding, Report, apply_waivers

__all__ = ["Finding", "Report", "apply_waivers"]
