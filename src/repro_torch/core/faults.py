"""Deterministic fault injection for the Libra datapath (the chaos
harness).

A :class:`FaultPlan` is a seeded schedule of failures injected at named
points of the stack — the harness the fault-tolerance layer (backend
health/failover, bounded retries, worker-failure migration, epoch policy
hot-swap) is tested against. Everything is driven by the plan's own
monotonic step clock (advanced once per runtime scheduling round) and by
keyed blake2b coins over *stable* identifiers (event id, backend index,
channel name, step), so a plan replays identically for identical
schedules — chaos runs are property-testable against fault-free runs.

Fault kinds (builder methods, chainable):

* :meth:`eagain` / :meth:`stall` — sends to backend index ``k`` fail with
  an *unexplained* EAGAIN (the socket is writable; there is no organic
  busy continuation to wait out) during a step window, with probability
  ``p`` per attempt. Exercises the channel's bounded retry/backoff loop
  and the HealthTable trip → failover path.
* :meth:`reset` — one-shot per channel: the first send to backend ``k``
  at/after step ``at`` finds the connection reset (the channel closes the
  backend socket). Exercises the dead-destination re-route/drop path.
* :meth:`pool_pressure` — holds ``fraction`` of a pool's free pages for a
  step window (watermark backpressure + §A.1 overflow under pressure).
* :meth:`kill_worker` — asks the :class:`ClusterRuntime` to kill worker
  ``w`` at step ``at`` (drain + flow migration + dead-owner grant
  copy-out).
* :meth:`corrupt` — flips one payload token of delivered frames with
  probability ``p`` per frame during a window. Frame-aware: the parser
  locates message boundaries and only payload spans are damaged, so
  framing survives and the corruption is *detectable* (an hw/sw-kTLS
  record fails its auth tag and is rejected-and-counted; the stream
  never wedges).
* :meth:`at` — a generic one-shot callback ``fn(runtime)`` at step
  ``when`` (policy-table swaps under traffic, ad-hoc chaos).

Install by passing ``fault_plan=plan`` to :class:`ProxyRuntime` or
:class:`ClusterRuntime` (which set ``stack.fault_plan`` on their stacks
and drive :meth:`on_tick` / :meth:`on_cluster_step` once per round), or
call :meth:`install` on a bare stack. ``plan.log`` records every fired
event; :meth:`release_all` returns any pages still held by pool-pressure
events (runtime shutdown calls it, so leak asserts stay meaningful).
"""
from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.anchor_pool import PoolExhausted


def _coin(seed: int, *key) -> float:
    """Deterministic uniform [0, 1) keyed on ``(seed, *key)`` — order-
    independent across unrelated draws (no shared RNG stream), so one
    extra consultation never perturbs every later coin."""
    h = hashlib.blake2b(repr(key).encode(),
                        key=struct.pack("<q", int(seed)), digest_size=8)
    return struct.unpack("<Q", h.digest())[0] / 2.0 ** 64


def _coin_int(seed: int, *key) -> int:
    h = hashlib.blake2b(repr(key).encode(),
                        key=struct.pack("<q", int(seed) ^ 0x5EED),
                        digest_size=8)
    return struct.unpack("<Q", h.digest())[0]


@dataclasses.dataclass
class _Event:
    kind: str                       # eagain|reset|pressure|kill|corrupt|at
    eid: int
    backend: int = -1
    start: int = 0
    until: Optional[int] = None     # None = open-ended window
    p: float = 1.0
    at: int = 0
    worker: int = -1
    fraction: float = 0.0
    fn: Optional[Callable] = None
    done: bool = False              # one-shot events (reset is per-channel)
    hits: int = 0
    hit_channels: Set[str] = dataclasses.field(default_factory=set)


class FaultPlan:
    """A seeded, deterministic schedule of injected faults (see module
    docstring). Builder methods return ``self`` for chaining."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        #: the plan's step clock — advanced once per runtime round by
        #: :meth:`on_tick` / :meth:`on_cluster_step`; every window/firing
        #: time is expressed in these steps
        self.now = 0
        self.events: List[_Event] = []
        #: (step, kind, detail...) tuples for every *fired* discrete event
        self.log: List[Tuple] = []
        self._serials: Dict[int, int] = {}        # sock id -> deliveries seen
        # process-global filenos are not replay-stable: coins and logs key
        # on a plan-local dense id assigned in first-seen order instead
        self._sock_ids: Dict[int, int] = {}
        # pool-pressure holds: (eid, id(alloc)) -> held PageRef list
        self._pressure: Dict[Tuple[int, int], list] = {}
        self._allocs: Dict[int, object] = {}

    # -- builders ------------------------------------------------------------
    def _add(self, **kw) -> "FaultPlan":
        self.events.append(_Event(eid=len(self.events), **kw))
        return self

    def eagain(self, backend: int, start: int = 0,
               until: Optional[int] = None, p: float = 1.0) -> "FaultPlan":
        """EAGAIN storm on backend index ``backend`` during steps
        ``[start, until)``: each send attempt fails with probability
        ``p`` (unexplained — counted against the retry budget)."""
        return self._add(kind="eagain", backend=int(backend),
                         start=int(start), until=until, p=float(p))

    def stall(self, backend: int, start: int = 0,
              until: Optional[int] = None) -> "FaultPlan":
        """Hard stall: every send to ``backend`` fails for the window
        (an :meth:`eagain` storm with p=1)."""
        return self.eagain(backend, start=start, until=until, p=1.0)

    def reset(self, backend: int, at: int = 0) -> "FaultPlan":
        """Connection reset: the first send each channel attempts to
        backend ``backend`` at/after step ``at`` finds the destination
        closed (one-shot per channel)."""
        return self._add(kind="reset", backend=int(backend), at=int(at))

    def pool_pressure(self, fraction: float, start: int = 0,
                      until: Optional[int] = None) -> "FaultPlan":
        """Hold ``fraction`` of each target pool's free pages for the
        window (released when it closes, and by :meth:`release_all`)."""
        assert 0.0 <= fraction <= 1.0, fraction
        return self._add(kind="pressure", fraction=float(fraction),
                         start=int(start), until=until)

    def kill_worker(self, worker: int, at: int) -> "FaultPlan":
        """Kill cluster worker ``worker`` at step ``at`` (one-shot;
        requires a :class:`ClusterRuntime` driving the plan)."""
        return self._add(kind="kill", worker=int(worker), at=int(at))

    def corrupt(self, p: float = 1.0, start: int = 0,
                until: Optional[int] = None) -> "FaultPlan":
        """Flip one payload token per delivered frame with probability
        ``p`` during the window (frame-aware — framing survives)."""
        return self._add(kind="corrupt", p=float(p), start=int(start),
                         until=until)

    def at(self, when: int, fn: Callable) -> "FaultPlan":
        """One-shot callback ``fn(runtime)`` at step ``when`` (e.g. a
        policy-table :meth:`~repro_torch.core.policy.PolicyTable.swap`)."""
        return self._add(kind="at", at=int(when), fn=fn)

    # -- installation --------------------------------------------------------
    def install(self, stack) -> "FaultPlan":
        """Attach to a bare :class:`LibraStack` (runtimes do this through
        their ``fault_plan=`` kwarg)."""
        stack.fault_plan = self
        return self

    # -- hook: channel send path ---------------------------------------------
    def _active(self, ev: _Event) -> bool:
        return ev.start <= self.now and (ev.until is None
                                         or self.now < ev.until)

    def send_fault(self, backend: int, channel: str) -> Optional[str]:
        """Consulted by the channel before every send attempt: returns
        ``'reset'`` (destination is to be closed), ``'eagain'`` (injected
        unexplained EAGAIN) or ``None``. Deterministic: the coin is keyed
        on (event, backend, channel, step), so re-consultation within one
        step agrees with itself."""
        for ev in self.events:
            if ev.kind == "reset" and ev.backend == backend \
                    and self.now >= ev.at \
                    and channel not in ev.hit_channels:
                ev.hit_channels.add(channel)
                ev.hits += 1
                self.log.append((self.now, "reset", backend, channel))
                return "reset"
        for ev in self.events:
            if ev.kind != "eagain" or ev.backend != backend \
                    or not self._active(ev):
                continue
            if ev.p >= 1.0 or _coin(self.seed, "eagain", ev.eid, backend,
                                    channel, self.now) < ev.p:
                ev.hits += 1
                return "eagain"
        return None

    # -- hook: ingress delivery ----------------------------------------------
    def corrupt_ingress(self, sock, data: np.ndarray) -> np.ndarray:
        """Consulted by ``LibraSocket.deliver``: frame-aware token
        corruption. The socket's parser walks the delivered chunk frame
        by frame; a corrupted frame gets ONE payload token XORed with a
        keyed nonzero value — framing intact, content damaged (an
        encrypted record then fails its auth tag downstream)."""
        active = [ev for ev in self.events
                  if ev.kind == "corrupt" and self._active(ev)]
        arr = np.asarray(data, np.int64)
        if not active or len(arr) == 0:
            return arr
        fd = self._sock_ids.setdefault(sock.fileno(), len(self._sock_ids))
        serial = self._serials.get(fd, 0)
        self._serials[fd] = serial + 1
        out = None
        pos = idx = 0
        while pos < len(arr):
            res = sock.parser.parse(arr[pos:])
            if not getattr(res, "ok", False) or res.payload_len < 0:
                break
            span = res.meta_len + res.payload_len
            if span <= 0 or pos + span > len(arr):
                break
            for ev in active:
                if res.payload_len <= 0:
                    continue
                if _coin(self.seed, "corrupt", ev.eid, fd, serial,
                         idx) >= ev.p:
                    continue
                if out is None:
                    out = arr.copy()
                off = pos + res.meta_len + int(
                    _coin_int(self.seed, "cpos", fd, serial, idx)
                    % res.payload_len)
                out[off] ^= 1 + int(_coin_int(self.seed, "cval", fd, serial,
                                              idx) % 997)
                ev.hits += 1
                self.log.append((self.now, "corrupt", fd, idx))
                break
            pos += span
            idx += 1
        return arr if out is None else out

    # -- hook: scheduler rounds ----------------------------------------------
    def on_tick(self, runtime) -> None:
        """One single-stack scheduling round: advance the step clock,
        apply pool pressure to the runtime's stack, fire due callbacks."""
        self.now += 1
        self._apply_pressure([runtime.stack])
        self._fire_ats(runtime)

    def on_cluster_step(self, runtime) -> None:
        """One cluster round: advance the clock, apply pressure to every
        live worker pool, fire due worker kills and callbacks."""
        self.now += 1
        live = [w for i, w in enumerate(runtime.cluster.workers)
                if i not in runtime.cluster.dead_workers]
        self._apply_pressure(live)
        for ev in self.events:
            if ev.kind == "kill" and not ev.done and self.now >= ev.at:
                ev.done = True
                ev.hits += 1
                self.log.append((self.now, "kill_worker", ev.worker))
                runtime.kill_worker(ev.worker)
        self._fire_ats(runtime)

    def _fire_ats(self, runtime) -> None:
        for ev in self.events:
            if ev.kind == "at" and not ev.done and self.now >= ev.at:
                ev.done = True
                ev.hits += 1
                self.log.append((self.now, "callback", ev.eid))
                ev.fn(runtime)

    def _apply_pressure(self, stacks) -> None:
        for ev in self.events:
            if ev.kind != "pressure":
                continue
            for st in stacks:
                key = (ev.eid, id(st.alloc))
                held = self._pressure.get(key)
                if self._active(ev) and held is None:
                    n = int(ev.fraction * st.alloc.free_pages)
                    pages = []
                    try:
                        for _ in range(n):
                            pages.append(st.alloc.alloc_page(0))
                    except PoolExhausted:
                        pass
                    self._pressure[key] = pages
                    self._allocs[id(st.alloc)] = st.alloc
                    ev.hits += 1
                    self.log.append((self.now, "pressure_on", len(pages)))
                elif not self._active(ev) and held:
                    st.alloc.free_pages_list(held)
                    self._pressure[key] = []
                    self.log.append((self.now, "pressure_off", len(held)))

    def release_all(self) -> int:
        """Free every page still held by pool-pressure events (runtime
        shutdown calls this before asserting zero leaks). Returns the
        number of pages released."""
        freed = 0
        for key, pages in list(self._pressure.items()):
            if pages:
                self._allocs[key[1]].free_pages_list(pages)
                freed += len(pages)
            self._pressure[key] = []
        return freed

    # -- telemetry -----------------------------------------------------------
    def summary(self) -> Dict[str, object]:
        by_kind: Dict[str, int] = {}
        for ev in self.events:
            by_kind[ev.kind] = by_kind.get(ev.kind, 0) + ev.hits
        return {"now": self.now, "events": len(self.events),
                "hits_by_kind": by_kind, "log_entries": len(self.log)}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"FaultPlan(seed={self.seed}, now={self.now}, "
                f"events={len(self.events)}, fired={len(self.log)})")
