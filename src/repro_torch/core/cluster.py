"""``LibraCluster`` — multi-worker scale-out of the Libra stack.

One :class:`~repro_torch.core.stack.LibraStack` is the paper's single-core
kernel instance: one anchor pool, one VPI map, one scheduler round.  Real
L7 deployments steer flows across many queues/cores *before* the proxy
sees them (RSS / application-defined receive-side dispatching) and keep
per-core state partitioned (XLB-style).  This module is that layer:

* :class:`SteeringPolicy` — the RSS analogue.  ``mode='hash'`` places a
  flow by **consistent hashing** its 4-tuple-analogue key onto a ring of
  virtual nodes (adding/removing a worker re-steers only ~1/N of flows);
  ``mode='app'`` delegates to an application callable (the RSD idea:
  steering is programmable, like the parser policies).  Live re-steering
  is supported and counted (``resteer``).
* :class:`LibraCluster` — owns N independent workers (each a full
  ``LibraStack``: own pool, own registry, own clock) plus the steering
  layer.  ``cluster.socket(flow=...)`` / ``socket_pair`` place endpoints
  transparently; the returned sockets are ordinary :class:`LibraSocket`\\ s.
* **Cross-worker handoff (the VPI grant protocol)** — a proxied flow whose
  src and dst land on different workers must move an anchored payload from
  worker A's pool to worker B's egress *without a user-space bounce*:

  - **zero-copy grant** (default): B's registry imports a grant entry that
    *references* A's pages (``VpiRegistry.import_grant``); A pins them with
    an extra refcount (``AnchorPool.export_grant``) so the grant safely
    outlives even A's §A.4 teardown grace.  B's egress composes the frame
    straight out of A's pool (``LibraStack.pool_for_entry`` routing; the
    batched path runs the fused gather against A's resident device pool —
    the peer-to-peer DMA analogue).  Completion forwards teardown back to
    A.  Counted in ``CopyCounters.cross_worker_grants``.
  - **one-copy fallback**: when B's pool sits above its watermark (a
    congested egress worker should not pin a peer's memory across a long
    backlog), the payload is gathered once out of A's pool at handoff time,
    A's anchor is released immediately (relieving the owner), and the grant
    entry carries the bytes itself (``entry.stash``).  The copied tokens
    are counted in ``CopyCounters.cross_worker_copied`` — separately from
    the Fig. 9 categories, so a cluster run stays **counter-identical** to
    a single-stack run at any cross-worker fraction.

* :class:`ClusterRuntime` — drives one :class:`ProxyRuntime` per worker
  round-robin, with **work stealing**: a worker whose ready set is empty
  services ready channels stolen from the most-backlogged peer (scalar
  quanta — channels are self-contained, so stealing changes *where* a
  quantum runs, never its bytes or counters).  Aggregated counters and
  latency summaries across workers; ``run_parallel`` reports per-worker
  wall times for the ideal-parallel throughput model (the workers are
  independent event loops — on real cores they run concurrently; the
  single-process repro emulates that by taking the slowest worker's
  critical path).

In the port every worker's pool is a :class:`~repro_torch.core.
device_pool.DevicePool` on ``LibraCluster(device=...)`` ("cuda" unless
the caller passes "cpu"), so a batched cluster holds one resident tensor
per worker on the card, and a zero-copy grant is gathered on the card out
of the owner's tensor. The one-copy fallback and the dead-owner copy-out
read the owner's pool through ``read_payload``, which first copies the
rows whose truth is on the card back to the host mirror. A killed
worker's pool is drained and checked fully free, but its device tensor
stays allocated until the cluster is dropped, as the JAX package keeps
its array. Worker threads launch on the current stream of their own
thread, the default stream, so every worker's kernels run in launch
order on one stream.
"""
from __future__ import annotations

import bisect
import hashlib
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.anchor_pool import PageRef
from repro_torch.core.runtime import ProxyChannel, ProxyRuntime
from repro_torch.core.socket import LibraSocket
from repro_torch.core.stack import LibraStack, ParserLike
from repro_torch.core.stream import CopyCounters
from repro_torch.core.sync import ClusterLock

#: steering callable signature for mode='app': (flow_key, n_workers) -> int
AppSteer = Callable[[object, int], int]


def _stable_hash(secret: bytes, obj: object) -> int:
    """Position on the steering ring: keyed blake2b of a stable encoding
    of the flow key (repr — flow keys are meant to be plain tuples/ints/
    strings, the 4-tuple analogue)."""
    h = hashlib.blake2b(repr(obj).encode(), key=secret, digest_size=8)
    return struct.unpack("<Q", h.digest())[0]


class _WorkerCtx:
    """Scopes ``LibraCluster.current_worker`` to one scheduling quantum
    (restoring the previous attribution on exit, so nested quanta — a
    survivor draining a dying worker's channel — unwind correctly)."""

    __slots__ = ("cluster", "w", "prev")

    def __init__(self, cluster: "LibraCluster", w: Optional[int]):
        self.cluster = cluster
        self.w = w

    def __enter__(self) -> "_WorkerCtx":
        self.prev = self.cluster.current_worker
        self.cluster.current_worker = self.w
        return self

    def __exit__(self, *exc) -> None:
        self.cluster.current_worker = self.prev


class SteeringPolicy:
    """RSS-style flow steering: flow key -> worker id.

    ``hash`` mode is a consistent-hash ring with ``replicas`` virtual
    nodes per worker — the same flow maps to the same worker across
    re-registration and across policy instances built with the same
    parameters, and resizing the worker set moves only ~1/N of flows.
    ``app`` mode delegates to ``app_fn(flow, n_workers)`` (the
    application-defined receive-side dispatching analogue).

    ``stats`` records live steering behaviour: per-worker placements,
    total decisions, and — across :meth:`resteer` calls — how many tracked
    flows actually moved.
    """

    MODES = ("hash", "app")

    def __init__(self, n_workers: int, mode: str = "hash",
                 app_fn: Optional[AppSteer] = None, replicas: int = 64,
                 secret: bytes = b"libra-steer"):
        assert mode in self.MODES, mode
        assert n_workers >= 1, n_workers
        if mode == "app" and app_fn is None:
            raise ValueError("mode='app' needs an app_fn(flow, n_workers)")
        self.mode = mode
        self.app_fn = app_fn
        self.replicas = replicas
        self.secret = secret
        self.n_workers = n_workers
        # every worker steers through this one object (placements, stats,
        # the ring): self-locking, per the repro_torch.core.sync discipline
        self.lock = ClusterLock("steering")
        # workers removed by failure: their vnodes leave the ring (hash
        # mode) / their index is skipped (app mode); indices of the
        # survivors never shift, so placements stay stable
        self.dead: set = set()
        self._ring: List[Tuple[int, int]] = []
        self._build_ring()
        # flow -> worker placements observed so far (live re-steer stats)
        self.placements: Dict[object, int] = {}
        self.stats = {"steered": 0, "resteers": 0, "moved": 0,
                      "per_worker": [0] * n_workers}

    def _build_ring(self) -> None:
        ring = []
        for w in range(self.n_workers):
            if w in self.dead:
                continue
            for r in range(self.replicas):
                ring.append((_stable_hash(self.secret, ("vnode", w, r)), w))
        assert ring, "steering needs at least one live worker"
        ring.sort()
        self._ring = ring
        self._ring_keys = [h for h, _ in ring]   # bisect array, built once

    def worker_for(self, flow: object, track: bool = True) -> int:
        """Steer ``flow`` (any hashable 4-tuple analogue) to a worker.
        ``track=False`` skips the placement record — used for one-shot
        auto-generated flow keys that can never recur, so a long-lived
        cluster's placement map stays bounded by *named* flows."""
        with self.lock:
            if self.mode == "app":
                w = int(self.app_fn(flow, self.n_workers)) % self.n_workers
                while w in self.dead:
                    # app steering is dead-worker-oblivious:
                    # deterministically walk to the next live index
                    # (consistent across callers)
                    w = (w + 1) % self.n_workers
            else:
                pos = _stable_hash(self.secret, flow)
                i = bisect.bisect_right(self._ring_keys, pos) \
                    % len(self._ring)
                w = self._ring[i][1]
            self.stats["steered"] += 1
            self.stats["per_worker"][w] += 1
            if track:
                self.placements[flow] = w
            return w

    def forget(self, flow: object) -> None:
        """Drop a tracked flow (its connection closed) from the placement
        map, so resteer stats cover only live flows."""
        with self.lock:
            self.placements.pop(flow, None)

    def resteer(self, n_workers: Optional[int] = None,
                mode: Optional[str] = None,
                app_fn: Optional[AppSteer] = None) -> int:
        """Live policy change (worker set resize / mode swap). Re-evaluates
        every tracked flow and returns how many moved (also accumulated in
        ``stats['moved']``) — with consistent hashing a resize moves only
        ~1/N of flows; a mode swap can move anything."""
        if mode is not None:
            assert mode in self.MODES, mode
        if (mode or self.mode) == "app" and (app_fn or self.app_fn) is None:
            # validate BEFORE mutating any state: a hash->app swap without
            # a callable must not die mid-resteer with stats half-reset
            raise ValueError("mode='app' needs an app_fn(flow, n_workers)")
        with self.lock:
            if n_workers is not None:
                self.n_workers = n_workers
            if mode is not None:
                self.mode = mode
            if app_fn is not None:
                self.app_fn = app_fn
            self._build_ring()
            self.stats["per_worker"] = ([0] * self.n_workers)
            self.stats["resteers"] += 1
            moved = 0
            old = dict(self.placements)
            for flow, prev in old.items():
                if self.worker_for(flow) != prev:
                    moved += 1
            self.stats["moved"] += moved
            return moved

    def remove_worker(self, w: int) -> int:
        """Take a failed worker out of the steering set: its vnodes leave
        the ring (app mode skips its index), survivor indices never shift,
        and every tracked flow is re-evaluated — with consistent hashing
        only the dead worker's ~1/N of flows move. Idempotent; returns how
        many flows moved."""
        with self.lock:
            if w in self.dead:
                return 0
            assert len(self.dead) + 1 < self.n_workers, \
                "cannot remove the last live worker"
            self.dead.add(w)
            return self.resteer()


class LibraCluster:
    """N independent :class:`LibraStack` workers + flow steering + the
    cross-worker VPI grant interconnect. Constructor keyword arguments
    other than the ones below are forwarded to every worker stack
    (``pages_per_shard``, ``page_size``, ``device_pool``, ``device``,
    ...)."""

    def __init__(self, n_workers: int = 2, *,
                 steering: Union[str, SteeringPolicy] = "hash",
                 app_fn: Optional[AppSteer] = None,
                 secret: Optional[bytes] = None,
                 grace_ticks: int = 5,
                 **stack_kw):
        assert n_workers >= 1, n_workers
        # ONE coarse cluster-plane lock (see repro_torch.core.sync): every
        # cross-worker mutation — grant pins, grant tables, freelists of a
        # peer pool — holds it; attached to each worker's alloc/registry so
        # the egress completion path can find it via plane_lock()
        self.lock = ClusterLock()
        # the worker whose scheduling quantum is executing right now (None
        # = control plane); maintained by ClusterRuntime via as_worker()
        # and read by the test-time LocksetMonitor. Thread-local: under
        # run_parallel(threads=True) each worker thread carries its own
        # attribution, while the cooperative scheduler keeps setting it
        # from the main thread exactly as before.
        self._worker_ctx = threading.local()
        self.workers: List[LibraStack] = []
        for i in range(n_workers):
            wsecret = (None if secret is None
                       else hashlib.blake2b(struct.pack("<q", i), key=secret,
                                            digest_size=16).digest())
            w = LibraStack(secret=wsecret, grace_ticks=grace_ticks,
                           **stack_kw)
            w.worker_id = i
            w.pool.pool_id = f"libra-worker-{i}"
            w.interconnect = self
            w.alloc.lock = self.lock
            w.registry.lock = self.lock
            self.workers.append(w)
        for w in self.workers:
            for peer in self.workers:
                if peer is not w:
                    w.register_peer_pool(peer.pool)
        self.steering = (steering if isinstance(steering, SteeringPolicy)
                         else SteeringPolicy(n_workers, mode=steering,
                                             app_fn=app_fn))
        assert self.steering.n_workers == n_workers, \
            (self.steering.n_workers, n_workers)
        self._flow_serial = 0
        self._worker_by_pool = {w.pool.pool_id: w for w in self.workers}
        # workers torn down by kill_worker: excluded from steering,
        # find_owner and the runtimes' scheduling (indices never shift)
        self.dead_workers: set = set()
        # cross-worker handoff telemetry (cluster-wide; the per-stack
        # CopyCounters carry the same events on the destination worker)
        self.stats = {"grants": 0, "grant_pages": 0,
                      "copies": 0, "copied_tokens": 0, "adopt_misses": 0,
                      "grants_reclaimed": 0, "worker_kills": 0,
                      "dead_grants_copied": 0, "migrated_flows": 0}

    # -- placement -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.workers)

    @property
    def current_worker(self) -> Optional[int]:
        return getattr(self._worker_ctx, "w", None)

    @current_worker.setter
    def current_worker(self, w: Optional[int]) -> None:
        self._worker_ctx.w = w

    def as_worker(self, w: Optional[int]) -> "_WorkerCtx":
        """Scope ``current_worker`` to ``w`` for one scheduling quantum —
        the attribution the lockset instrumentation uses to tell a
        worker-context mutation from control-plane bookkeeping."""
        return _WorkerCtx(self, w)

    def _next_flow(self) -> Tuple[str, int]:
        self._flow_serial += 1
        return ("flow", self._flow_serial)

    def worker_for(self, flow: object) -> LibraStack:
        return self.workers[self.steering.worker_for(flow)]

    def socket(self, parser: ParserLike = "length-prefixed", *,
               flow: Optional[object] = None,
               worker: Optional[int] = None, **kw) -> LibraSocket:
        """Open a connection somewhere on the cluster: ``worker`` pins it,
        ``flow`` steers it through the policy, neither auto-assigns a fresh
        flow key. The returned socket is an ordinary :class:`LibraSocket`
        (its ``worker_id`` tells where it landed)."""
        if worker is not None:
            stack = self.workers[worker]
        elif flow is not None:
            stack = self.workers[self.steering.worker_for(flow)]
        else:
            stack = self.workers[self.steering.worker_for(
                self._next_flow(), track=False)]
        return stack.socket(parser, **kw)

    def socket_pair(self, parser: ParserLike = "length-prefixed", *,
                    flow: Optional[object] = None,
                    **kw) -> Tuple[LibraSocket, LibraSocket]:
        """A (client-side, backend-side) pair of ONE proxied flow — both
        endpoints land on the same worker (flow affinity, the RSS
        property). Cross-worker channels arise when a channel pairs
        sockets of *different* flows."""
        track = flow is not None
        if flow is None:
            flow = self._next_flow()
        w = self.steering.worker_for(flow, track=track)
        stack = self.workers[w]
        return stack.socket(parser, **kw), stack.socket(parser, **kw)

    # -- the VPI grant interconnect -----------------------------------------
    def find_owner(self, vpi: int,
                   exclude: Optional[LibraStack] = None
                   ) -> Optional[LibraStack]:
        """The worker whose registry holds ``vpi`` live (TEARDOWN entries
        do not count: their §A.4 grace belongs to the owner)."""
        for w in self.workers:
            if w is exclude or w.worker_id in self.dead_workers:
                continue
            if w.registry.peek(vpi) is not None:
                return w
        return None

    def grant_into(self, dst_stack: LibraStack, vpi: int) -> Optional[int]:
        """Adopt ``vpi`` — anchored on some peer worker — into
        ``dst_stack``'s registry so its egress can transmit the payload.
        Returns the destination-side VPI, or None when no live owner
        exists cluster-wide (stale handle: the caller's FALLBACK_BYPASS
        takes over, exactly as single-stack).

        Zero-copy grant by default; the counted one-copy fallback when the
        destination pool is above its watermark (see module docstring).

        Holds the cluster-plane lock end to end: the adoption reads the
        owner's registry and mutates two workers' state (pin + grant
        entry), and the caller may be ANY worker's egress quantum."""
        with self.lock:
            return self._grant_into_locked(dst_stack, vpi)

    def _grant_into_locked(self, dst_stack: LibraStack,
                           vpi: int) -> Optional[int]:
        owner = self.find_owner(vpi, exclude=dst_stack)
        if owner is None:
            self.stats["adopt_misses"] += 1
            return None
        entry = owner.registry.peek(vpi)
        pages = list(entry.pages)
        if entry.stash is not None:
            # the owner entry is itself a one-copy handoff: forward the
            # stashed bytes as-is (self-contained — no pool, no pin, no
            # additional copy; the bytes already left the owning pool)
            return dst_stack.registry.import_grant(
                owner.registry, vpi, dst_stack.pool.pool_id, [],
                entry.payload_len, stash=entry.stash)
        if entry.grant is not None:
            # the owner entry is itself a zero-copy grant: FLATTEN the
            # chain — pin and reference the ROOT pool/registry directly so
            # completion always releases the true owner, never a
            # middleman's bookkeeping (the middleman's grant lives on,
            # released by its own transmit or the shutdown reclaim)
            root = entry.grant
            root_worker = self._worker_by_pool.get(entry.pool_id, owner)
            root_worker.alloc.export_grant([PageRef(*pg) for pg in pages])
            try:
                new_vpi = dst_stack.registry.import_grant(
                    root.owner_registry, root.owner_vpi, entry.pool_id, pages,
                    entry.payload_len)
            except BaseException:
                # a pin must never outlive a failed import — that is the
                # abandoned-grant leak in miniature (OWN001)
                root_worker.alloc.release_export(
                    [PageRef(*pg) for pg in pages])
                raise
            dst_stack.counters.cross_worker_grants += 1
            self.stats["grants"] += 1
            self.stats["grant_pages"] += len(pages)
            return new_vpi
        if dst_stack.alloc.above_watermark():
            # one-copy fallback: gather once out of the owner's pool, free
            # the owner's anchor immediately (the copy IS the handoff), and
            # ship the bytes on the grant entry itself
            refs = [PageRef(*pg) for pg in pages]
            payload = owner.pool.read_payload(refs, entry.payload_len)
            dst_stack.counters.cross_worker_copied += entry.payload_len
            self.stats["copies"] += 1
            self.stats["copied_tokens"] += entry.payload_len
            new_vpi = dst_stack.registry.import_grant(
                owner.registry, vpi, dst_stack.pool.pool_id, [],
                entry.payload_len, stash=payload)
            owner_sock = owner._anchor_owner(vpi)
            if owner.registry.release(vpi):
                owner.alloc.free_pages_list(refs)
            if owner_sock is not None:
                owner_sock.connection.anchored.pop(vpi, None)
            return new_vpi
        # zero-copy grant: pin the owner's pages, reference them from the
        # destination registry, forward teardown on completion (egress)
        owner.alloc.export_grant([PageRef(*pg) for pg in pages])
        try:
            new_vpi = dst_stack.registry.import_grant(
                owner.registry, vpi, owner.pool.pool_id, pages,
                entry.payload_len)
        except BaseException:
            owner.alloc.release_export([PageRef(*pg) for pg in pages])
            raise
        dst_stack.counters.cross_worker_grants += 1
        self.stats["grants"] += 1
        self.stats["grant_pages"] += len(pages)
        return new_vpi

    # -- cluster-wide lifecycle / telemetry ----------------------------------
    def reclaim_abandoned_grants(self) -> int:
        """Release cross-worker handoff entries that will never transmit
        (their grantee socket closed, or shutdown abandoned the message
        holding the granted VPI). Drops each zero-copy grant's pin on the
        owner's pool — the egress completion that normally does this can
        no longer happen — and removes the entry; stash entries just go.
        Returns the number of entries reclaimed. Called by
        :meth:`ClusterRuntime.shutdown` after every socket is closed and
        grace periods have drained (the single-stack analogue: staged
        frames abandoned on closed sockets die at shutdown)."""
        reclaimed = 0
        with self.lock:
            for w in self.workers:
                for entry in w.registry.handoffs():
                    if entry.grant is not None:
                        owner = self._worker_by_pool.get(entry.pool_id)
                        if owner is not None:
                            owner.alloc.release_export(
                                [PageRef(*pg) for pg in entry.pages])
                    w.registry.drop(entry.vpi)
                    reclaimed += 1
        self.stats["grants_reclaimed"] += reclaimed
        return reclaimed

    def kill_worker(self, w: int) -> Dict[str, int]:
        """Tear down worker ``w`` as a *failure* (state-plane half; the
        :class:`ClusterRuntime` drains and migrates flows first):

        1. Survivor registries holding **zero-copy grants into the dying
           pool** copy the payload out while the pages still exist —
           the grant becomes a self-contained stash entry (counted in
           ``cross_worker_copied``, like the live one-copy fallback) and
           the dead pool's pin is released. Survivors' in-flight messages
           therefore stay byte-identical.
        2. Grants the dying worker held **into survivor pools** release
           their pins (the dead-owner extension of
           :meth:`reclaim_abandoned_grants`) and are dropped.
        3. Every dying-worker socket closes; grace periods flush.
        4. The worker leaves the steering set (idempotent with a prior
           :meth:`SteeringPolicy.remove_worker`) and joins
           ``dead_workers``.

        Ends by asserting the dead pool leaked nothing: every page free,
        zero outstanding grant pins. Returns a small accounting dict.
        Holds the cluster-plane lock end to end — the sweep walks and
        mutates every survivor's grant table and the dying pool."""
        with self.lock:
            return self._kill_worker_locked(w)

    def _kill_worker_locked(self, w: int) -> Dict[str, int]:
        assert 0 <= w < len(self.workers), w
        assert w not in self.dead_workers, f"worker {w} already dead"
        dead = self.workers[w]
        info = {"grants_copied_out": 0, "grants_released": 0,
                "pages_reclaimed": 0, "flows_resteered": 0}
        for surv in self.workers:
            if surv is dead or surv.worker_id in self.dead_workers:
                continue
            for entry in surv.registry.handoffs():
                if entry.grant is None \
                        or entry.pool_id != dead.pool.pool_id:
                    continue
                refs = [PageRef(*pg) for pg in entry.pages]
                entry.stash = dead.pool.read_payload(refs, entry.payload_len)
                entry.grant = None
                entry.pages = []
                entry.pool_id = surv.pool.pool_id
                dead.alloc.release_export(refs)
                surv.counters.cross_worker_copied += entry.payload_len
                self.stats["copies"] += 1
                self.stats["copied_tokens"] += entry.payload_len
                self.stats["dead_grants_copied"] += 1
                info["grants_copied_out"] += 1
        for entry in dead.registry.handoffs():
            if entry.grant is not None:
                owner = self._worker_by_pool.get(entry.pool_id)
                if owner is not None and owner is not dead:
                    owner.alloc.release_export(
                        [PageRef(*pg) for pg in entry.pages])
                    info["grants_released"] += 1
            dead.registry.drop(entry.vpi)
        dead.close_all()
        info["pages_reclaimed"] = dead.drain()
        info["flows_resteered"] = self.steering.remove_worker(w)
        self.dead_workers.add(w)
        self.stats["worker_kills"] += 1
        assert dead.alloc.granted_out_pages == 0, \
            f"worker {w} leaked {dead.alloc.granted_out_pages} grant pins"
        assert dead.alloc.free_pages == dead.alloc.total_pages, \
            (f"worker {w} leaked pages: {dead.alloc.free_pages}/"
             f"{dead.alloc.total_pages} free")
        return info

    def assert_no_leaks(self) -> None:
        """The zero-leak guarantee, checked pool by pool: every page back
        on its freelist, zero outstanding grant pins, no handoff entries
        left in any registry (dead workers included — their teardown
        already enforced this)."""
        for w in self.workers:
            a = w.alloc
            assert a.granted_out_pages == 0, \
                (w.worker_id, "granted_out_pages", a.granted_out_pages)
            assert a.free_pages == a.total_pages, \
                (w.worker_id, "pages", a.free_pages, a.total_pages)
            assert not w.registry.handoffs(), \
                (w.worker_id, "handoff entries remain")

    def tick(self, n: int = 1) -> int:
        return sum(w.tick(n) for w in self.workers)

    def drain(self) -> int:
        return sum(w.drain() for w in self.workers)

    def close_all(self) -> int:
        return sum(w.close_all() for w in self.workers)

    @property
    def pages_in_use(self) -> int:
        return sum(w.pages_in_use for w in self.workers)

    def counters_aggregate(self) -> CopyCounters:
        """Cluster-wide CopyCounters (field-wise sum over workers) — the
        quantity that must be identical to a single-stack run of the same
        workload, at any cross-worker fraction."""
        agg = CopyCounters()
        for w in self.workers:
            for f in CopyCounters.__dataclass_fields__:
                setattr(agg, f, getattr(agg, f) + getattr(w.counters, f))
        return agg

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"LibraCluster(workers={len(self.workers)}, "
                f"steering={self.steering.mode}, "
                f"grants={self.stats['grants']}, "
                f"copies={self.stats['copies']})")


class ClusterRuntime:
    """One :class:`ProxyRuntime` per worker, driven round-robin, with
    optional work stealing between idle and backlogged workers."""

    def __init__(self, cluster: LibraCluster, *,
                 work_stealing: bool = True, steal_batch: int = 4,
                 policy=None, fault_plan=None, **rt_kw):
        self.cluster = cluster
        # chaos harness: one FaultPlan for the whole cluster — installed
        # on every worker stack (send/deliver hooks) and driven once per
        # CLUSTER round via on_cluster_step (worker kills, pool pressure,
        # scheduled callbacks); the per-worker runtimes do not drive it
        self.fault_plan = fault_plan
        if fault_plan is not None:
            for w in cluster.workers:
                fault_plan.install(w)
        # per-worker L7 policy tables: a PolicyTable is cloned per worker
        # (token-bucket state is worker-local, like every other hot-path
        # structure); a callable ``policy(worker_id)`` builds each worker's
        # table instead, for deliberately heterogeneous clusters
        if policy is None:
            tables = [None] * len(cluster.workers)
        elif callable(policy):
            tables = [policy(i) for i in range(len(cluster.workers))]
        else:
            tables = [policy.clone() for _ in cluster.workers]
        self.policies = tables
        self.runtimes = [ProxyRuntime(w, policy=t, **rt_kw)
                         for w, t in zip(cluster.workers, tables)]
        self.work_stealing = work_stealing
        self.steal_batch = steal_batch
        self.rounds = 0
        self.stats = {"steals": 0, "stolen_quanta": 0}

    def policy_summary(self) -> dict:
        """Cluster-wide policy telemetry: the field-wise sum of each
        worker's table stats (mirroring :meth:`LibraCluster.
        counters_aggregate` — the totals must match a single-worker run of
        the same workload), plus the per-worker summaries."""
        per_worker = [None if t is None else t.summary()
                      for t in self.policies]
        agg: dict = {}
        for s in per_worker:
            if s is None:
                continue
            for k, v in s.items():
                if isinstance(v, int):
                    agg[k] = agg.get(k, 0) + v
                elif isinstance(v, list):
                    cur = agg.setdefault(k, [0] * len(v))
                    for i, x in enumerate(v):
                        cur[i] += x
                elif isinstance(v, dict):
                    cur = agg.setdefault(k, {})
                    for rk, rv in v.items():
                        cur[rk] = cur.get(rk, 0) + rv
        return {"aggregate": agg, "per_worker": per_worker}

    # -- registration --------------------------------------------------------
    def channel(self, src: LibraSocket, dst, **kw) -> ProxyChannel:
        """Create a channel and register it on the runtime of the worker
        that owns ``src`` (ingress locality: the receive side is where the
        flow was steered; a dst on another worker makes the channel
        cross-worker and exercises the grant protocol)."""
        rt = self.runtimes[src.worker_id]
        return rt.channel(src, dst, **kw)

    @property
    def channels(self) -> List[ProxyChannel]:
        return [c for rt in self.runtimes for c in rt.channels]

    # -- scheduling ----------------------------------------------------------
    def step(self) -> int:
        """One cluster round: each worker runtime takes one scheduling
        round over its own channels; with work stealing, a worker whose
        ready set is empty first services up to ``steal_batch`` ready
        channels of the most-backlogged peer (scalar quanta — a channel
        is self-contained, so the bytes and counters it produces are
        identical wherever the quantum runs)."""
        progressed = 0
        stolen: set = set()
        dead = self.cluster.dead_workers
        if not self.work_stealing:
            for i, rt in enumerate(self.runtimes):
                if i not in dead:
                    with self.cluster.as_worker(i):
                        progressed += rt.step()
            self.rounds += 1
            if self.fault_plan is not None:
                self.fault_plan.on_cluster_step(self)
            return progressed
        # one readiness evaluation per channel per round: the same lists
        # drive both the stealing decision and each runtime's step
        readys = [([] if i in dead else rt.poll())
                  for i, rt in enumerate(self.runtimes)]
        for i, rdy in enumerate(readys):
            if rdy or i in dead:
                continue
            donor = max(range(len(readys)),
                        key=lambda j: len([c for c in readys[j]
                                           if c not in stolen]))
            avail = [c for c in readys[donor] if c not in stolen]
            if len(avail) < 2:
                continue  # nothing worth stealing (donor keeps its one)
            take = avail[-(min(self.steal_batch, len(avail) // 2)):]
            self.stats["steals"] += 1
            for ch in take:
                stolen.add(ch)
                self.stats["stolen_quanta"] += 1
                # steal-under-lock: the THIEF executes the quantum while
                # holding the plane lock, so the stolen channel's state
                # (the donor's pool/registry) is owner-pinned for the
                # whole handoff — LocksetMonitor attributes the mutations
                # with no special case, and a threaded donor can never
                # race the thief on its own freelists
                with self.cluster.lock:
                    with self.cluster.as_worker(i):
                        progressed += bool(ch.service())
        for i, (rt, rdy) in enumerate(zip(self.runtimes, readys)):
            if i in dead:
                continue
            with self.cluster.as_worker(i):
                progressed += rt.step(
                    skip=stolen if stolen else None,
                    ready=[c for c in rdy if c not in stolen])
        self.rounds += 1
        if self.fault_plan is not None:
            self.fault_plan.on_cluster_step(self)
        return progressed

    def kill_worker(self, w: int, drain_rounds: int = 20000) -> Dict[str, int]:
        """Worker failure with in-flight flow migration (the runtime-plane
        half; :meth:`LibraCluster.kill_worker` finishes the state plane):

        1. **Quiesce** the dying worker's runtime: continuations and held
           sends finish where the backend allows (bounded — retries against
           faulted backends expire into counted timeouts). Survivors mid-
           continuation *into* the dying worker finish too (a budget send
           always accepts bytes, so both loops terminate).
        2. Stragglers that cannot finish (held messages whose anchor dies
           with the worker, half-reassembled messages) are force-dropped
           and counted — their pages free through the close/drain below.
        3. Each dying-worker **flow migrates**: a fresh socket on a
           steering-chosen survivor takes over the channel — the kTLS
           session object moves with it (keys and sequence state ride
           along), undelivered receive-ring bytes are re-delivered
           verbatim, and the channel (stats and all) re-registers on the
           survivor's runtime. Backend sockets on the dying worker are NOT
           migrated — they died with it; health/failover re-routes their
           traffic.
        4. :meth:`LibraCluster.kill_worker` copies dead-owner grants out,
           releases pins, closes/drains the dead stack, removes it from
           steering, and asserts the dead pool leaked nothing.
        """
        cluster = self.cluster
        assert w not in cluster.dead_workers, f"worker {w} already dead"
        rt = self.runtimes[w]
        dead_stack = cluster.workers[w]
        guard = drain_rounds
        with cluster.as_worker(w):
            while guard > 0 and rt.step() > 0:
                guard -= 1
        for i, rt2 in enumerate(self.runtimes):
            if i == w or i in cluster.dead_workers:
                continue
            for ch in rt2.channels:
                guard = drain_rounds
                with cluster.as_worker(i):
                    while ch._inflight is not None \
                            and ch._inflight.stack is dead_stack \
                            and guard > 0:
                        ch.service()
                        guard -= 1
        # steering loses the worker now so migration targets are live
        # (idempotent — LibraCluster.kill_worker's call becomes a no-op)
        cluster.steering.remove_worker(w)
        migrated = 0
        # migration rebinds channels onto survivor workers (fresh sockets,
        # kTLS session moves, runtime re-registration): survivor state
        # mutated from the control plane — hold the plane lock throughout
        with cluster.lock:
            migrated = self._migrate_channels_locked(rt, w, cluster)
        info = cluster.kill_worker(w)
        info["flows_migrated"] = migrated
        return info

    def _migrate_channels_locked(self, rt, w: int, cluster) -> int:
        migrated = 0
        dead_stack = cluster.workers[w]
        for ch in list(rt.channels):
            # stragglers: a held message's anchor dies with this worker —
            # a counted timeout-drop, pages freed via the stack teardown
            if ch._held is not None:
                h, ch._held = ch._held, None
                ch._expire_held(h)
            if ch._rx_parts:
                ch._rx_parts, ch._rx_logical = [], 0
                ch.stats.drops += 1
            ch._pending_verdict = None
            old = ch.src
            if old.closed:
                continue
            tw = cluster.steering.worker_for(("migrate", old.fileno()),
                                             track=False)
            tgt = cluster.workers[tw]
            new = tgt.socket(old.parser,
                             min_payload=old.connection.rx_machine.min_payload,
                             send_budget=old.send_budget)
            if old.tls is not None:
                # kTLS flow migration: the session OBJECT moves — keys and
                # record sequence state continue on the new worker
                new.tls = old.tls
                new.connection.crypto = old.tls
            pend = old.connection.rx_peek(old.rx_available())
            if len(pend):
                # internal hand-off, not network delivery: bypass the
                # socket's fault hook (no double corruption)
                new.connection.deliver(np.array(pend))
            old.close()
            if ch.policy is rt.policy:
                ch.policy = None     # inherit the survivor's table clone
            ch.src = new
            rt.channels.remove(ch)
            self.runtimes[tw].register(ch)
            migrated += 1
            cluster.stats["migrated_flows"] += 1
        return migrated

    def run(self, max_rounds: int = 10 ** 6) -> int:
        """Interleaved cluster loop until no worker has ready work."""
        rounds = 0
        while rounds < max_rounds:
            if self.step() == 0:
                break
            rounds += 1
        return self.messages_forwarded()

    def run_parallel(self, max_rounds: int = 10 ** 6, *,
                     threads: bool = False, epoch_rounds: int = 256
                     ) -> Tuple[int, List[float]]:
        """Run each worker's runtime to completion independently and
        return ``(messages_forwarded, per-worker wall seconds)``. The
        workers are independent event loops (cross-worker forwards are
        driven entirely by the src-side channel), so on real cores they
        run concurrently; with ``threads=False`` the single-process repro
        emulates the parallel wall clock as ``max(per-worker seconds)``
        — the critical path.

        ``threads=True`` makes it real: one OS thread per live worker,
        each scoped to its island via the thread-local worker context.
        Byte- and counter-identical to the emulated scheduler (the only
        cross-thread state — peer pools/registries on the grant path —
        is plane-locked end to end; the grant-vs-copy choice depends
        only on destination watermark pressure, not on interleaving).
        With a ``fault_plan``, workers run in *epochs* of
        ``epoch_rounds`` rounds with a full barrier between epochs: the
        control plane fires due fault events (worker kills migrate flows
        while every worker thread is joined), so ``at=`` times are in
        epoch units under this executor.
        """
        if not threads:
            times: List[float] = []
            for i, rt in enumerate(self.runtimes):
                t0 = time.perf_counter()
                with self.cluster.as_worker(i):
                    rt.run(max_rounds)
                times.append(time.perf_counter() - t0)
            return self.messages_forwarded(), times
        return self._run_threads(max_rounds, epoch_rounds)

    def _run_threads(self, max_rounds: int, epoch_rounds: int
                     ) -> Tuple[int, List[float]]:
        times = [0.0] * len(self.runtimes)
        errors: List[BaseException] = []

        def drive(i: int, rt: ProxyRuntime, budget: int) -> None:
            t0 = time.perf_counter()
            try:
                with self.cluster.as_worker(i):
                    rt.run(budget)
            except BaseException as e:  # propagate to the joining thread
                errors.append(e)
            finally:
                times[i] += time.perf_counter() - t0

        def epoch(budget: int) -> None:
            ts = [threading.Thread(target=drive, args=(i, rt, budget),
                                   name=f"libra-worker-{i}")
                  for i, rt in enumerate(self.runtimes)
                  if i not in self.cluster.dead_workers]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            if errors:
                raise errors[0]

        if self.fault_plan is None:
            epoch(max_rounds)
            return self.messages_forwarded(), times

        # epoch-barrier loop: threads run epoch_rounds, join, then the
        # control plane (single-threaded) fires due fault events — a
        # kill_worker migration never races a live worker thread
        plan = self.fault_plan
        rounds_left = max_rounds
        last_msgs = -1
        while rounds_left > 0:
            epoch(min(epoch_rounds, rounds_left))
            rounds_left -= epoch_rounds
            self.rounds += 1
            plan.on_cluster_step(self)
            msgs = self.messages_forwarded()
            pending = any(
                (ev.kind in ("kill", "at") and not ev.done)
                or (ev.kind == "reset" and plan.now < ev.at)
                for ev in plan.events)
            busy = any(rt.poll() for i, rt in enumerate(self.runtimes)
                       if i not in self.cluster.dead_workers)
            if msgs == last_msgs and not busy and not pending:
                break
            last_msgs = msgs
        return self.messages_forwarded(), times

    def shutdown(self) -> int:
        if self.fault_plan is not None:
            self.fault_plan.release_all()
        deferred = sum(rt.shutdown() for rt in self.runtimes)
        # grants whose transmit was abandoned by the shutdown would pin
        # their owner's pages forever — reclaim them now that every
        # socket is closed and every grace period has drained; then close
        # any stray non-channel sockets, flush the last grace periods, and
        # hold the zero-leak guarantee on every pool
        self.cluster.close_all()
        self.cluster.drain()
        self.cluster.reclaim_abandoned_grants()
        self.cluster.assert_no_leaks()
        return deferred

    # -- telemetry -----------------------------------------------------------
    def messages_forwarded(self) -> int:
        return sum(rt.messages_forwarded() for rt in self.runtimes)

    def logical_bytes(self) -> int:
        return sum(rt.logical_bytes() for rt in self.runtimes)

    def latency_summary(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for i, rt in enumerate(self.runtimes):
            for name, s in rt.latency_summary().items():
                out[f"w{i}/{name}"] = s
        return out
