"""Event-driven multi-connection proxy runtime (the epoll loop analogue).

This is the piece that lets one :class:`LibraStack` behave like the proxies
the paper evaluates: an event loop multiplexing N client↔backend flows with
heterogeneous parser policies, bounded send buffers, and a periodic tick
that drives deferred-teardown expiry — all through the POSIX-shaped
:class:`LibraSocket` facade (no pool/registry/counter plumbing at any
call-site).

Model:

* :class:`ProxyChannel` — one proxied flow. ``recv`` on the client-side
  socket, optionally rewrite the metadata (L7 policy), route to one of the
  backend sockets, ``forward`` with this channel's send budget. A
  budget-truncated message stays "in flight" and is continued on later
  quanta before new data is read (TCP ordering per flow). Channels apply
  pool **backpressure**: when the stack is above its watermark, a channel
  whose next frame would anchor pauses instead of overflowing into the
  §A.1 drain path (disable per channel with ``backpressure=False``).
* :class:`ProxyRuntime` — readiness-set scheduler. ``step()`` is one
  scheduling round: poll all channels, service the ready ones (round-robin
  rotation or strict priority order), and advance the stack clock every
  ``tick_every`` rounds. With ``batched=True`` a round gathers every ready
  channel's admissible frame into ONE ``LibraStack.recv_batch`` /
  ``forward_batch`` pair (a single data-plane pass for the whole round);
  channels in edge states (mid-message, drain, held/in-flight sends, pool
  exhaustion, unparseable frames) transparently fall back to their scalar
  quantum, so semantics and counters match the scalar scheduler exactly.
  ``run()`` loops until idle.

Every channel records a per-quantum latency histogram
(:class:`LatencyHistogram`, log₂ buckets) — ``ProxyRuntime.latency_summary``
reports p50/p99 per channel; batched rounds charge each participant the
amortized share of the round's data-plane time.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import struct
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.crypto import RecordAuthError
from repro_torch.core.policy import PUNT_BAD_BACKEND, Verdict
from repro_torch.core.socket import Events, LibraSocket
from repro_torch.core.stack import SEND_EAGAIN, LibraStack
from repro_torch.core.state_machine import St

Router = Callable[[np.ndarray, int], LibraSocket]
Rewrite = Callable[[np.ndarray, int], np.ndarray]

#: sentinel: a quantum consumed input but produced nothing to transmit
_IDLE = object()
#: policy verdict said PUNT: fall through to the channel's Python callbacks
_PUNT = object()


class LatencyHistogram:
    """Log₂-bucketed latency histogram (quantum-scale timings).

    Bucket k covers [lo·2ᵏ, lo·2ᵏ⁺¹); percentiles report the geometric
    midpoint of the covering bucket — cheap, allocation-free telemetry
    (no per-sample storage)."""

    __slots__ = ("lo", "counts", "count", "total")

    def __init__(self, lo: float = 1e-7, n_buckets: int = 40):
        self.lo = lo
        self.counts = [0] * n_buckets
        self.count = 0
        self.total = 0.0

    def record(self, seconds: float) -> None:
        b = 0 if seconds <= self.lo else int(math.log2(seconds / self.lo)) + 1
        self.counts[min(max(b, 0), len(self.counts) - 1)] += 1
        self.count += 1
        self.total += seconds

    def percentile(self, q: float) -> float:
        """q in [0, 1] -> seconds (0.0 when empty)."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for b, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                if b == 0:
                    return self.lo
                return self.lo * (2.0 ** (b - 1)) * math.sqrt(2.0)
        return self.lo * 2.0 ** (len(self.counts) - 1)

    def summary(self) -> Dict[str, float]:
        return {"count": self.count,
                "mean": self.total / max(self.count, 1),
                "p50": self.percentile(0.50),
                "p99": self.percentile(0.99)}


@dataclasses.dataclass
class ChannelStats:
    # frames fully handed to the backend socket; a chunked application
    # message counts one frame per chunk plus its terminator
    messages: int = 0
    logical_bytes: int = 0     # logical bytes accepted by sends
    recv_calls: int = 0
    send_calls: int = 0
    partial_sends: int = 0     # sends truncated by the budget
    quanta: int = 0            # scheduling quanta consumed
    bp_pauses: int = 0         # quanta skipped by pool backpressure
    auth_rejects: int = 0      # tampered records rejected by the tag check
    drops: int = 0             # messages consumed by a DROP verdict (or a
                               # router callback returning None)
    retries: int = 0           # unexplained-EAGAIN retry attempts (backend
                               # fault, not a busy continuation)
    timeouts: int = 0          # held messages that exhausted their retry
                               # budget (or met a dead backend with no
                               # failover): dropped with pages freed
    failovers: int = 0         # held messages re-routed to their rule's
                               # failover backend after the primary tripped
    # deficit-round-robin state (scheduler="drr"): the channel's current
    # byte deficit — grows by quantum_bytes per round while backlogged,
    # shrinks by the logical bytes each serviced message accepted, resets
    # when the channel goes idle (classic DRR)
    deficit: float = 0.0
    # per-quantum wall-clock latency (batched rounds charge the amortized
    # share of the round's single data-plane pass)
    latency: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)


def _jitter(name: str, tries: int, spread: int = 4) -> int:
    """Deterministic backoff jitter in [0, spread): keyed blake2b over the
    (channel name, attempt) pair, so concurrent channels de-synchronise
    their retry storms without a shared RNG stream. Keyed on the *name*
    (stable across runs), not a process-global fileno — chaos runs must
    replay identically."""
    h = hashlib.blake2b(struct.pack("<q", tries) + name.encode(),
                        digest_size=2)
    return struct.unpack("<H", h.digest())[0] % spread


@dataclasses.dataclass
class _HeldSend:
    """One routed message whose transmit could not start (backend EAGAIN,
    reset, or an injected fault): held on the channel and retried on later
    quanta. ``tries``/``wait``/``age`` drive the bounded-retry loop —
    *organic* EAGAINs (the backend is busy with another flow's truncated
    message, which provably drains) retry every quantum forever, exactly
    as the pre-fault-tolerance runtime did; *unexplained* EAGAINs (the
    socket is writable yet the send failed — a fault) are counted against
    ``max_retries`` with exponential backoff."""
    out: object                    # the composed outgoing buffer
    dst: LibraSocket               # current destination (failover may move it)
    logical: int                   # logical size (the DRR cost peek)
    rule: int = -1                 # policy row that routed it (failover lookup)
    tries: int = 0                 # unexplained attempts so far
    wait: int = 0                  # backoff quanta before the next attempt
    age: int = 0                   # quanta since first held (retry_timeout)


class ProxyChannel:
    """One proxied flow through the L7 proxy."""

    def __init__(self, src: LibraSocket,
                 dst: Union[LibraSocket, Sequence[LibraSocket]], *,
                 router: Optional[Router] = None,
                 rewrite: Optional[Rewrite] = None,
                 policy=None,
                 recv_buf: int = 1 << 20,
                 budget: Optional[int] = None,
                 priority: int = 0,
                 name: Optional[str] = None,
                 backpressure: bool = True,
                 max_retries: Optional[int] = 8,
                 retry_timeout: Optional[int] = None):
        self.src = src
        self.dsts: List[LibraSocket] = (
            list(dst) if isinstance(dst, (list, tuple)) else [dst])
        self.router = router      # (buf, logical) -> backend socket
        self.rewrite = rewrite    # (buf, logical) -> outgoing buffer
        # offloaded L7 routing: a PolicyTable whose verdicts replace the
        # rewrite/router callbacks for matched messages. Batched rounds
        # compute verdicts in recv_batch's fused match pass; scalar quanta
        # (and batched fallbacks) resolve through the same table in Python.
        # PUNT verdicts fall through to the callbacks above — they are the
        # slow path the offload keeps, not a competing mechanism.
        self.policy = policy
        self._pending_verdict = None   # verdict parked by the fused pass
        self.recv_buf = recv_buf
        self.budget = budget
        self.priority = priority
        self.name = name or f"ch{src.fileno()}"
        self.backpressure = backpressure
        self.stats = ChannelStats()
        self._inflight: Optional[LibraSocket] = None
        # reassembly of a selective-copy message that needed several recv
        # calls (recv_buf smaller than metadata+VPI, or capped logical)
        self._rx_parts: List[np.ndarray] = []
        self._rx_logical = 0
        # message routed to a backend whose send buffer was busy with
        # another flow's truncated message (EAGAIN): retried next quantum
        self._held: Optional[_HeldSend] = None
        # bounded-retry knobs for UNEXPLAINED send failures (faults) —
        # organic busy-backend EAGAINs stay hold-forever (they drain):
        # after max_retries unexplained attempts (or retry_timeout held
        # quanta, when set) the message is dropped with its pages freed
        # and counted in ChannelStats.timeouts
        self.max_retries = max_retries
        self.retry_timeout = retry_timeout
        self._dst_index = {d.fileno(): i for i, d in enumerate(self.dsts)}
        self._route_rule = -1    # policy row behind the message being sent
        # set by ready() when backpressure (alone) kept the channel out of
        # the ready set this round — the scheduler's liveness fallback
        self._bp_paused = False

    def ready(self) -> bool:
        self._bp_paused = False
        # outbound work (a truncated or held message) outlives the client
        # connection — §A.4 teardown lets the frame finish transmitting
        if self._inflight is not None or self._held is not None:
            return True
        if self.src.closed:
            return False
        if self._rx_parts:
            return True
        if not self.src.poll() & Events.READABLE:
            return False
        # L7 policy: wait for a parseable frame rather than forwarding the
        # unframed prefix of a message still arriving (raw unparseable
        # streams — need_more False — still flow through as full copies)
        if self.src.needs_more_data():
            return False
        # pool backpressure: a frame that would anchor waits while the pool
        # sits above its watermark — egress quanta drain it — instead of
        # overflowing into the §A.1 full-copy drain path
        if self.backpressure and self.src.next_frame_selective() \
                and self.src.stack.above_watermark():
            self._bp_paused = True
            self.stats.bp_pauses += 1
            return False
        return True

    def next_cost(self) -> Optional[int]:
        """Logical size of the head-of-line work item — the DRR "packet
        size" peek: the remaining pending message on a continuation, the
        held (EAGAIN) message, the capped logical remainder of a message
        mid-delivery, or the next parseable frame's logical length
        (memoised parse; no extra window scan). A channel that is ready
        always gets a finite cost (None only when nothing is pending), so
        credit accumulation always converges on an affordable message."""
        if self._inflight is not None:
            p = self._inflight.pending_send
            return max(p.logical - p.accepted, 1) if p is not None else 1
        if self._held is not None:
            # the logical size recorded at hold time — the composed buffer
            # is [meta..., VPI], far smaller than the bytes the transmit
            # will be charged
            return max(self._held.logical, 1)
        if self.src.closed:
            return None
        sm = self.src.connection.rx_machine
        if sm.state is St.FAST_PATH and not sm.complete():
            # recv_buf-capped logical remainder (reassembly in progress)
            return max(sm.payload_len - sm.payload_consumed, 1)
        res = self.src.parse_pending()
        if res.ok:
            return max(res.meta_len + max(res.payload_len, 0), 1)
        avail = self.src.rx_available()
        if avail:
            return min(avail, self.recv_buf)
        return 1 if self._rx_parts else None

    def _mid_message(self) -> bool:
        """True while the RX machine is inside one selective-copy message
        (deferred VPI, or logical length capped by recv_buf)."""
        sm = self.src.connection.rx_machine
        if sm.state is St.METADATA_PARSED:
            return True
        return sm.state is St.FAST_PATH and not sm.complete()

    def service(self) -> bool:
        """One quantum of work; returns True if progress was made."""
        t0 = time.perf_counter()
        try:
            return self._service()
        finally:
            self.stats.latency.record(time.perf_counter() - t0)

    def _service(self) -> bool:
        self.stats.quanta += 1
        if self._inflight is not None:
            return self._continue_send()
        if self._held is not None:
            h = self._held
            if h.wait > 0:
                # waiting out an exponential-backoff window IS progress
                # toward the bounded retry (and keeps run() alive while
                # every other channel is also waiting out a fault)
                h.wait -= 1
                h.age += 1
                return True
            if self.retry_timeout is not None and h.age >= self.retry_timeout:
                self._held = None
                return self._expire_held(h)
            self._held = None
            nd = self._failover_dst(h)
            if nd is not None:
                h.dst = nd
                h.tries = 0          # a healthy failover gets a fresh budget
                self.stats.failovers += 1
            return self._start_send(h.out, h.dst, h.logical, held=h)
        try:
            buf, logical = self.src.recv(self.recv_buf)
        except RecordAuthError:
            # a tampered record was rejected (consumed, nothing anchored):
            # one bad flow must not abort the event loop — mirror the
            # batched path, which drops the bad slot and keeps the round
            # alive. Direct socket users still see the raise.
            self.stats.auth_rejects += 1
            return True
        self.stats.recv_calls += 1
        if logical == 0 and len(buf) == 0:
            return False
        intent = self._ingest(buf, logical)
        if intent is None:
            return True          # fragment absorbed: progress
        if intent is _IDLE:
            return False
        return self._start_send(*intent)

    def _ingest(self, buf: np.ndarray, logical: int):
        """Post-recv half of a quantum: reassembly, rewrite, routing.
        Returns ``(out, dst, logical)`` when a whole message is ready to
        transmit, ``None`` when a fragment was absorbed, ``_IDLE`` on no
        progress."""
        if self._mid_message():
            # fragment of one message: reassemble before routing, so the
            # whole message goes to ONE backend in one send
            self._rx_parts.append(buf)
            self._rx_logical += logical
            return None
        if self._rx_parts:
            self._rx_parts.append(buf)
            buf = np.concatenate(self._rx_parts)
            logical += self._rx_logical
            self._rx_parts, self._rx_logical = [], 0
        if logical == 0:
            return _IDLE
        self._route_rule = -1
        if self.policy is not None:
            v, self._pending_verdict = self._pending_verdict, None
            if v is None:
                # scalar quantum (or batched fallback): same table, Python
                # resolution — the slow path the offload keeps. Payload-
                # prefix conditions peek the anchored first page through
                # the host mirror, matching the fused kernel's window.
                st = self.src.stack
                payload, plen = (None, 0)
                if getattr(self.policy, "has_payload_conds", False):
                    payload, plen = st._policy_window(buf, self.src)
                v = self.policy.decide(
                    buf, parser=self.src.parser,
                    crypto=self.src.connection.crypto is not None,
                    now=st.now_tick, counters=st.counters,
                    payload=payload, payload_len=plen)
            intent = self._apply_verdict(v, buf, logical)
            if intent is not _PUNT:
                return intent
        out = self.rewrite(buf, logical) if self.rewrite else buf
        dst = self.router(buf, logical) if self.router else self.dsts[0]
        if dst is None:
            # the router declined the message (the Python baseline's DROP):
            # consume it and free its anchored pages — the same path a
            # DROP verdict takes, so baselines stay byte/page-identical
            return self._drop(buf)
        return out, dst, logical

    def _apply_verdict(self, v: Verdict, buf: np.ndarray, logical: int):
        """Turn a fused-pass (or scalar-path) policy verdict into a
        transmit intent: FORWARD → ``(out, dst, logical)`` with REWRITE
        patches applied to a copy, DROP → consume and free, PUNT (including
        a backend index this channel does not have) → the ``_PUNT``
        sentinel, handing the message to the classic callbacks."""
        counters = self.src.stack.counters
        if v.kind == "forward" and v.backend >= len(self.dsts):
            v = Verdict("punt", rule=v.rule, reason=PUNT_BAD_BACKEND)
        self.policy.note_outcome(v)
        if v.kind == "forward":
            counters.policy_hits += 1
            self._route_rule = v.rule   # held-send failover consults the row
            out = buf
            if v.rewrites:
                out = np.array(buf)
                for slot, value in v.rewrites:
                    out[slot] = value
            return out, self.dsts[v.backend], logical
        if v.kind == "drop":
            counters.policy_drops += 1
            return self._drop(buf)
        counters.policy_punts += 1
        return _PUNT

    def _drop(self, buf: np.ndarray):
        """Consume a delivered message without transmitting: release its
        anchor (pages straight back to the freelist) and report the
        fragment-absorbed intent (``None`` = progress, nothing to send)."""
        self.src.stack.drop_message(buf, self.src)
        self.stats.drops += 1
        return None

    # -- fault-tolerant send path --------------------------------------------
    def _fault_for(self, dst: LibraSocket) -> Optional[str]:
        """Consult the stack's installed FaultPlan (if any) for an injected
        send fault toward this destination. Deterministic within a step, so
        the batched tile and the scalar path agree."""
        plan = getattr(self.src.stack, "fault_plan", None)
        if plan is None:
            return None
        return plan.send_fault(self._backend_index(dst), self.name)

    def _backend_index(self, dst: LibraSocket) -> int:
        return self._dst_index.get(dst.fileno(), -1)

    def _health(self):
        return getattr(self.policy, "health", None) \
            if self.policy is not None else None

    def _note_backend_failure(self, dst: LibraSocket) -> None:
        h = self._health()
        if h is not None:
            h.note_failure(self._backend_index(dst), self.src.stack.now_tick)

    def _note_backend_success(self, dst: LibraSocket) -> None:
        h = self._health()
        if h is not None:
            h.note_success(self._backend_index(dst))

    def _failover_dst(self, h: _HeldSend) -> Optional[LibraSocket]:
        """The healthy failover destination for a held message whose
        primary backend has tripped (or died); None when the primary is
        still allowed, or no usable failover exists."""
        pol = self.policy
        health = self._health()
        if health is None or h.rule is None or h.rule < 0:
            return None
        cur = self._backend_index(h.dst)
        if cur >= 0 and health.healthy(cur) and not h.dst.closed:
            return None              # primary still admissible: keep it
        fo = pol.failover_for(h.rule)
        if fo < 0 or fo >= len(self.dsts) or fo == cur:
            return None
        d = self.dsts[fo]
        if d.closed or not health.healthy(fo):
            return None
        return d

    def _expire_held(self, h: _HeldSend) -> bool:
        """Bounded-retry expiry: the message is undeliverable — free its
        anchored pages and count the timeout (the alternative, the classic
        hold-forever EAGAIN loop, wedges the channel and leaks the pages
        against a permanently dead backend)."""
        self.src.stack.drop_message(np.asarray(h.out, np.int64), self.src)
        self.stats.timeouts += 1
        return True

    def _dead_dst(self, out, dst: LibraSocket, logical: Optional[int],
                  held: Optional[_HeldSend]) -> bool:
        """A send met a closed backend (connection reset, or its worker
        was killed): note the failure, re-route to the rule's healthy
        failover when one exists, otherwise drop with pages freed."""
        self._note_backend_failure(dst)
        h = held if held is not None else _HeldSend(
            out, dst, logical if logical is not None else len(out),
            rule=self._route_rule)
        nd = self._failover_dst(h)
        if nd is not None:
            h.dst = nd
            h.tries = 0
            self.stats.failovers += 1
            return self._start_send(h.out, nd, h.logical, held=h)
        return self._expire_held(h)

    def _start_send(self, out, dst: LibraSocket,
                    logical: Optional[int] = None,
                    held: Optional[_HeldSend] = None) -> bool:
        fault = self._fault_for(dst)
        if fault == "reset" and not dst.closed:
            # injected connection reset: the first send finds the backend
            # gone — close it so every later attempt (any channel) agrees
            dst.close()
        if dst.closed:
            return self._dead_dst(out, dst, logical, held)
        if fault == "eagain" and dst.pending_send is None:
            # injected stall: the socket is writable, so this EAGAIN has no
            # organic cause — counted against the retry budget
            return self._note_send_outcome(dst, 0, out, eagain=True,
                                           logical=logical, held=held,
                                           injected=True)
        try:
            n = self.src.forward(dst, out, budget=self.budget)
        except BlockingIOError:
            return self._note_send_outcome(dst, 0, out, eagain=True,
                                           logical=logical, held=held)
        return self._note_send_outcome(dst, n, out, held=held)

    def _note_send_outcome(self, dst: LibraSocket, n: int, out,
                           eagain: bool = False,
                           logical: Optional[int] = None,
                           held: Optional[_HeldSend] = None,
                           injected: bool = False) -> bool:
        """Shared bookkeeping for scalar and batched transmits."""
        if eagain:
            h = held if held is not None else _HeldSend(
                out, dst, logical if logical is not None else len(out),
                rule=self._route_rule)
            h.out, h.dst = out, dst
            h.age += 1
            if injected or (dst.pending_send is None and not dst.closed):
                # unexplained EAGAIN — no busy continuation to wait out: a
                # backend fault. Bounded retries with exponential backoff;
                # organic EAGAINs below stay hold-forever (they drain).
                h.tries += 1
                self.stats.retries += 1
                self._note_backend_failure(dst)
                if self.max_retries is not None \
                        and h.tries > self.max_retries:
                    nd = self._failover_dst(h)
                    if nd is not None:
                        h.dst, h.tries, h.wait = nd, 0, 0
                        self.stats.failovers += 1
                        self._held = h
                        return True
                    return self._expire_held(h)
                h.wait = min(1 << (h.tries - 1), 64) \
                    + _jitter(self.name, h.tries)
                # scheduling the bounded retry IS progress — without it a
                # round where every channel meets an injected fault would
                # look idle and run() would exit with messages still held
                self._held = h
                return True
            self._held = h
            return False
        self.stats.send_calls += 1
        self.stats.logical_bytes += n
        if dst.pending_send is not None:
            self._inflight = dst
            self.stats.partial_sends += 1
        else:
            self.stats.messages += 1
            self._note_backend_success(dst)
        return True

    def _continue_send(self) -> bool:
        dst = self._inflight
        if dst.closed:
            # the backend died mid-continuation (reset / worker kill): the
            # partially-accepted message cannot complete — abandon it (the
            # destination's teardown already entered its grace period; the
            # source anchor drains at close)
            self._inflight = None
            self.stats.timeouts += 1
            self._note_backend_failure(dst)
            return True
        n = dst.send(budget=self.budget)
        self.stats.send_calls += 1
        self.stats.logical_bytes += n
        if dst.pending_send is None:
            self._inflight = None
            self.stats.messages += 1
            self._note_backend_success(dst)
        else:
            self.stats.partial_sends += 1
        return n > 0


class ProxyRuntime:
    """Readiness-set scheduler over one stack's channels.

    Scheduling policies: ``round-robin`` (rotating fairness over ready
    channels), ``priority`` (strict order by ``ProxyChannel.priority``),
    and ``drr`` — weighted-fair deficit round robin: every ready channel
    earns ``quantum_bytes`` of deficit per round and services head-of-line
    messages while its deficit covers them, so flows with 10:1 message
    sizes still converge to ~equal *byte* shares (a pure quantum-per-round
    scheduler gives them 10:1 bytes). DRR is a scalar-quanta policy —
    batched rounds fuse the whole ready set into one data-plane pass and
    have no per-message service order to weight."""

    SCHEDULERS = ("round-robin", "priority", "drr")

    def __init__(self, stack: LibraStack, *, scheduler: str = "round-robin",
                 tick_every: int = 16, batched: bool = False,
                 batch_impl: str = "host",
                 batch_tile: Optional[int] = None,
                 quantum_bytes: int = 1024,
                 policy=None,
                 fault_plan=None):
        assert scheduler in self.SCHEDULERS, scheduler
        assert not (batched and scheduler == "drr"), \
            "drr is a scalar-quanta policy (batched rounds fuse the ready set)"
        self.stack = stack
        # runtime-wide L7 PolicyTable: channels registered without their own
        # table inherit it, and batched rounds whose whole tile shares it
        # fuse the match into recv_batch's data-plane pass
        self.policy = policy
        self.scheduler = scheduler
        self.quantum_bytes = quantum_bytes
        self.tick_every = tick_every
        self.batched = batched
        # recv_batch/forward_batch data plane ('host', a kernel impl, or
        # 'fused-round[:impl]' for one-kernel scheduling rounds)
        self.batch_impl = batch_impl
        # channels fused per recv/forward pass: one round is processed in
        # tiles so a tile's anchored pages are transmitted while still
        # cache-hot. None (default) = adaptive — the tile is sized each
        # round from the ready set's live footprint (message pages ×
        # page_size vs the pool's cache budget), so tiny messages fuse by
        # the hundred while page-heavy rounds fall back to small tiles;
        # an int pins the tile (0 = whole round in one pass)
        self.batch_tile = batch_tile
        # chaos harness: a FaultPlan driven once per scheduling round (and
        # installed on the stack so the socket/channel hooks see it)
        self.fault_plan = fault_plan
        if fault_plan is not None:
            fault_plan.install(stack)
        self.channels: List[ProxyChannel] = []
        self.rounds = 0
        self._rr = 0

    # -- registration --------------------------------------------------------
    def register(self, channel: ProxyChannel) -> ProxyChannel:
        if channel.policy is None:
            channel.policy = self.policy
        self.channels.append(channel)
        return channel

    def channel(self, src: LibraSocket, dst, **kw) -> ProxyChannel:
        """Create and register a channel in one call. The default name is
        the registration ordinal (stable across identical runs — fault
        coins and backoff jitter key on it), not the process-global fd."""
        kw.setdefault("name", f"ch{len(self.channels)}")
        return self.register(ProxyChannel(src, dst, **kw))

    # -- scheduling ----------------------------------------------------------
    def poll(self, skip=None) -> List[ProxyChannel]:
        """The ready set, ordered by the active scheduling policy.
        ``skip`` excludes channels already serviced elsewhere this round
        (cluster work stealing)."""
        ready = [c for c in self.channels if c.ready()
                 and (skip is None or c not in skip)]
        if not ready:
            return ready
        if self.scheduler == "priority":
            return sorted(ready, key=lambda c: -c.priority)
        k = self._rr % len(ready)
        return ready[k:] + ready[:k]

    def step(self, skip=None, ready=None) -> int:
        """One scheduling round: give each ready channel one quantum (with
        ``batched=True``, one fused recv/forward pass for the whole ready
        set; with ``scheduler='drr'``, as many head-of-line messages as
        the channel's byte deficit covers). Returns the number of channels
        that made progress. ``skip`` excludes channels a cluster thief
        already serviced this round; ``ready`` supplies a ready set the
        caller already polled (ClusterRuntime), so channels are not
        readiness-evaluated twice per round."""
        if ready is None:
            ready = self.poll(skip)
        progressed = (self._step_batched(ready) if self.batched
                      else self._step_scalar(ready))
        if progressed == 0:
            # liveness: if backpressure alone paused the remaining work and
            # nothing else can free pool pages, admit the paused channels —
            # worst case they overflow into §A.1 drain, exactly as without
            # backpressure
            for ch in self.channels:
                if ch._bp_paused and (skip is None or ch not in skip):
                    ch._bp_paused = False
                    progressed += bool(ch.service())
        self.rounds += 1
        self._rr += 1
        if self.tick_every and self.rounds % self.tick_every == 0:
            self.stack.tick()
            h = getattr(self.policy, "health", None) \
                if self.policy is not None else None
            if h is not None:
                # advance the circuit-breaker clock with the stack's: due
                # UNHEALTHY backends move to HALF_OPEN (probe allowed)
                h.tick(self.stack.now_tick)
        if self.fault_plan is not None:
            self.fault_plan.on_tick(self)
        return progressed

    def _step_scalar(self, ready) -> int:
        if self.scheduler == "drr":
            return self._step_drr(ready)
        progressed = 0
        for ch in ready:
            progressed += bool(ch.service())
        return progressed

    def _step_drr(self, ready) -> int:
        """Deficit round robin: each ready channel earns ``quantum_bytes``
        and services whole head-of-line messages while the deficit covers
        their logical size — byte-fair across heterogeneous message
        sizes."""
        progressed = 0
        accumulating = 0
        for ch in ready:
            st = ch.stats
            st.deficit += self.quantum_bytes
            serviced = False
            while True:
                cost = ch.next_cost()
                if cost is None or cost > st.deficit:
                    break
                before = st.logical_bytes
                ok = ch.service()
                serviced = True
                charged = st.logical_bytes - before
                # charge ONLY bytes actually accepted: an EAGAIN-held or
                # fragment-absorbing quantum keeps its credit and pays the
                # real bytes when the message finally transmits (charging
                # the estimate here would bill such messages twice and
                # starve EAGAIN-prone flows of their byte-fair share) —
                # but a zero-byte quantum ends the inner loop, so the
                # deficit always drains across rounds
                if charged > 0:
                    st.deficit -= charged
                progressed += bool(ok)
                if not ok or charged == 0 or not ch.ready():
                    break
            if not ch.ready():
                st.deficit = 0.0   # classic DRR: going idle forfeits credit
            elif not serviced:
                accumulating += 1
        if progressed == 0 and accumulating:
            # a head-of-line message larger than quantum_bytes needs
            # several rounds of credit before it becomes affordable —
            # accumulating deficit IS forward progress (the deficit grows
            # by a positive quantum per round, so the message is reached
            # in finitely many rounds); without this, run()'s idle
            # detection would stop on the first credit-only round and
            # never forward it
            progressed = 1
        return progressed

    def _step_batched(self, ready) -> int:
        progressed = 0
        batch: List[ProxyChannel] = []
        for ch in ready:
            # edge states keep their scalar quantum (continuations, held
            # messages, reassembly in progress)
            if ch._inflight is not None or ch._held is not None \
                    or ch._rx_parts or ch.src.closed:
                progressed += bool(ch.service())
            else:
                batch.append(ch)
        # one fused recv/forward pass per tile: a tile's anchored pages are
        # forwarded while still cache-hot instead of after the whole round
        if self.batch_tile is None:
            tile = self._adaptive_tile(batch)
        else:
            tile = self.batch_tile if self.batch_tile > 0 else len(batch)
        tile = max(tile, 1)
        for i in range(0, len(batch), tile):
            progressed += self._service_tile(batch[i : i + tile])
        return progressed

    def _adaptive_tile(self, batch: List[ProxyChannel]) -> int:
        """Tile size from the round's live footprint, via the pool's one
        footprint→tile policy (:meth:`TokenPool.tile_for_footprint`), so
        round tiling and the pool's internal scatter/gather tiling never
        desynchronize. Uses the memoised parse results, so sizing costs no
        extra window scans."""
        page = self.stack.alloc.page_size
        pages = n = 0
        for ch in batch:
            res = ch.src.parse_pending()
            if res.ok and res.payload_len > 0:
                pages += -(-res.payload_len // page)
                n += 1
        if n == 0:
            return max(len(batch), 1)
        return self.stack.pool.tile_for_footprint(pages, n,
                                                  cap=max(len(batch), 1))

    def _service_tile(self, batch: List[ProxyChannel]) -> int:
        if not batch:
            return 0
        progressed = 0
        # fuse the L7 match into the recv pass only when the whole tile
        # shares ONE table (mixed tables would double-debit token buckets);
        # channels with their own tables still resolve in _ingest
        pol = self.policy
        if pol is not None and not all(ch.policy is pol for ch in batch):
            pol = None
        # fused one-kernel rounds speculate each flow's egress: hint the
        # primary destination so the fused gather TX-encrypts in the same
        # launch (forward_batch validates the guess — policy reroutes and
        # failovers simply miss the cache and pay the classic gather)
        hints = None
        if self.batch_impl.startswith("fused-round"):
            hints = {ch.src.fileno(): ch.dsts[0] for ch in batch if ch.dsts}
        t0 = time.perf_counter()
        results = self.stack.recv_batch(
            [ch.src for ch in batch],
            {ch.src.fileno(): ch.recv_buf for ch in batch},
            impl=self.batch_impl, policy=pol, tx_hints=hints)
        # data-plane time only: scalar fallbacks below record their own
        # quanta and must not inflate the batched channels' share
        dp_elapsed = time.perf_counter() - t0
        sends, senders, logicals = [], [], []
        n_batched = 0
        for ch in batch:
            r = results.get(ch.src.fileno())
            # pop the fused pass's verdict (if any); messages mid-
            # reassembly keep it parked on the channel until the last
            # fragment arrives — the match ran on the full metadata
            v = ch.src._policy_verdict
            ch.src._policy_verdict = None
            if r is not None and v is not None:
                ch._pending_verdict = v
            if r is None:
                if ch.src._auth_rejected:
                    # the auth sweep dropped this channel's record: count
                    # the reject on the channel, exactly as the scalar
                    # path's RecordAuthError handling does
                    ch.src._auth_rejected = False
                    ch.stats.auth_rejects += 1
                    progressed += 1
                    continue
                # the batch filled the pool past the watermark before this
                # channel's turn: pause it (backpressure) instead of letting
                # the scalar fallback overflow into §A.1 drain
                if ch.backpressure and self.stack.above_watermark() \
                        and ch.src.next_frame_selective():
                    ch._bp_paused = True
                    ch.stats.bp_pauses += 1
                    continue
                # not admissible this round (drain, short/unparseable frame,
                # exhaustion, tiny recv_buf, ...): scalar fallback quantum
                progressed += bool(ch.service())
                continue
            n_batched += 1
            ch.stats.quanta += 1
            ch.stats.recv_calls += 1
            intent = ch._ingest(*r)
            if intent is None:
                progressed += 1          # capped fragment absorbed
                continue
            if intent is _IDLE:
                continue
            out, dst, logical = intent
            if dst.closed or ch._fault_for(dst) is not None:
                # faulted or dead backend: the scalar send path owns the
                # retry/failover machinery (the fault coin is keyed per
                # step, so this consult and _start_send's agree)
                progressed += bool(ch._start_send(out, dst, logical))
                continue
            sends.append((ch.src, dst, out, ch.budget))
            senders.append(ch)
            logicals.append(logical)
        if sends:
            t1 = time.perf_counter()
            outcomes = self.stack.forward_batch(sends, impl=self.batch_impl)
            dp_elapsed += time.perf_counter() - t1
            for (ch, (_src, dst, out, _b), (status, n), logical) in zip(
                    senders, sends, outcomes, logicals):
                progressed += bool(
                    ch._note_send_outcome(dst, n, out,
                                          eagain=(status == SEND_EAGAIN),
                                          logical=logical))
        if n_batched:
            # charge each participant its amortized share of the tile's
            # fused recv/forward passes
            share = dp_elapsed / n_batched
            for ch in batch:
                if results.get(ch.src.fileno()) is not None:
                    ch.stats.latency.record(share)
        return progressed

    def run(self, max_rounds: int = 10 ** 6) -> int:
        """Loop until no channel is ready (or ``max_rounds``). Returns the
        total number of messages forwarded across all channels."""
        rounds = 0
        while rounds < max_rounds:
            if self.step() == 0:
                break
            rounds += 1
        return self.messages_forwarded()

    def shutdown(self) -> int:
        """Close every channel endpoint and flush all grace periods.
        Returns the number of pages reclaimed by deferred teardown."""
        if self.fault_plan is not None:
            self.fault_plan.release_all()
        for ch in self.channels:
            ch.src.close()
            for d in ch.dsts:
                d.close()
        return self.stack.drain()

    # -- telemetry -----------------------------------------------------------
    def messages_forwarded(self) -> int:
        return sum(c.stats.messages for c in self.channels)

    def logical_bytes(self) -> int:
        return sum(c.stats.logical_bytes for c in self.channels)

    def latency_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-channel quantum latency summary: name -> {count, mean, p50,
        p99} (seconds)."""
        return {c.name: c.stats.latency.summary() for c in self.channels}
