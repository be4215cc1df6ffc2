"""Cluster-plane synchronization primitives.

The single-process repro is cooperatively scheduled today, but the
ROADMAP's worker-per-thread executor makes every object reachable from two
workers a data race: grant pins and freelists (``AnchorPool``), the grant
tables (``VpiRegistry``), steering placements (``SteeringPolicy``) and the
shared circuit-breaker (``HealthTable``). This module provides the locks
that discipline those objects *now*, so the lockset checker
(:mod:`repro.analysis.lockset`) can statically verify every cross-worker
mutation site is guarded before any thread ever exists:

* :class:`ClusterLock` — a reentrant lock that additionally exposes
  :attr:`~ClusterLock.held` (is the *current thread* inside it?), which is
  what the test-time ``LocksetMonitor`` interrogates at each mutation.
* :func:`plane_lock` — the lock guarding an object's cluster plane, or a
  shared no-op when the object is single-stack (no ``.lock`` attached):
  the scalar datapath pays one ``getattr`` and nothing else.

Locking discipline (coarse by design — one plane lock per cluster, taken
around whole cross-worker operations; fine-graining is follow-up work once
the executor lands):

1. ``LibraCluster`` owns one :class:`ClusterLock` and attaches it to every
   worker's ``alloc`` and ``registry``.
2. Cross-worker operations (``grant_into``, grant completion in
   ``libra_send``, policy-DROP of a grant, ``reclaim_abandoned_grants``,
   ``kill_worker``) hold the plane lock end to end.
3. ``SteeringPolicy`` and ``HealthTable`` are self-locking: their mutators
   take their own per-object lock internally (they are shared through
   ``PolicyTable.clone()`` across every worker's table).
4. Lock order (statically enforced by the DEAD pass of
   :mod:`repro.analysis.concurrency` against the committed
   ``lock_hierarchy_manifest.json``) — acquisition must follow strictly
   increasing rank:

   ====================  ====  ===================================
   lock class            rank  acquired as
   ====================  ====  ===================================
   plane                 0     ``with cluster.lock`` / ``*_locked``
   registry              1     ``with plane_lock(<registry>)``
   alloc                 2     ``with plane_lock(<pool>.alloc)``
   steering / health     3     ``with self.lock`` (leaf, self-locking)
   ====================  ====  ===================================

   Same-class re-acquisition is always fine (``ClusterLock`` is
   reentrant, and in a cluster the plane/registry/alloc classes are
   today the *same* lock object — the ranking is the contract that
   keeps a future per-island fine-graining deadlock-free). Leaves never
   nest with each other.
"""
from __future__ import annotations

import threading


class ClusterLock:
    """Reentrant lock with an observable held-by-this-thread state.

    ``threading.RLock`` cannot be asked "does the current thread hold
    you?" — the lockset instrumentation needs exactly that question, so
    this wrapper tracks the owning thread id and the reentry depth itself.
    """

    __slots__ = ("name", "_lock", "_owner", "_depth", "acquires")

    def __init__(self, name: str = "cluster-plane"):
        self.name = name
        self._lock = threading.RLock()
        self._owner: int | None = None
        self._depth = 0
        self.acquires = 0

    def acquire(self) -> None:
        self._lock.acquire()
        self._owner = threading.get_ident()
        self._depth += 1
        self.acquires += 1

    def release(self) -> None:
        assert self._depth > 0 and self._owner == threading.get_ident(), \
            f"{self.name}: release without matching acquire"
        self._depth -= 1
        if self._depth == 0:
            self._owner = None
        self._lock.release()

    @property
    def held(self) -> bool:
        """True iff the *current thread* is inside this lock."""
        return self._depth > 0 and self._owner == threading.get_ident()

    def __enter__(self) -> "ClusterLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ClusterLock({self.name!r}, depth={self._depth})"


class _NullLock:
    """No-op stand-in for single-stack objects (no cluster, no sharing)."""

    held = False

    def __enter__(self) -> "_NullLock":
        return self

    def __exit__(self, *exc) -> None:
        return None


NULL_LOCK = _NullLock()


def plane_lock(obj) -> object:
    """The cluster-plane lock attached to ``obj`` (by ``LibraCluster``),
    or the shared no-op lock for single-stack objects."""
    lock = getattr(obj, "lock", None)
    return NULL_LOCK if lock is None else lock
