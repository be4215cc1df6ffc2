"""``LibraSocket`` — the POSIX-shaped per-connection facade.

The paper's headline property is that selective copy slots under an
*unmodified* proxy: the application calls ``recv``/``send``/``close`` and
never sees pools, registries, or tick clocks. This module restores that
surface for the repro: a ``LibraSocket`` wraps one :class:`Connection` and
routes every call through the owning :class:`~repro_torch.core.stack.LibraStack`'s
pool/registry/counters, so call-sites carry no plumbing.

Semantics mirrored from the kernel implementation:

* ``recv(buf_len)``   — instrumented recvmsg (§3.3). Returns
  ``(buffer, logical_len)``: on the selective path the buffer holds
  ``[metadata..., VPI]`` while ``logical_len`` covers metadata + anchored
  payload (recv transparency).
* ``send(buf)``       — instrumented sendmsg (§3.4) on THIS socket. The
  anchoring (source) connection is resolved from the embedded VPI through
  the stack's owner map, just as the kernel resolves it through the global
  eBPF map. ``send()`` with no buffer continues a budget-truncated message.
* ``forward(dst, buf)`` — the proxy idiom: message received on ``self``,
  transmitted on ``dst`` (``self`` is the anchor owner).
* ``close()``         — §A.4 safe teardown; still-anchored payloads enter
  the grace period and are reclaimed by ``LibraStack.tick()``.
* ``poll()``          — readiness bits for the event-driven runtime.

Partial sends: selective-copy (FAST_PATH) messages resume from the TX
machine's cumulative offset — callers re-enter with ``send()`` until
``pending_send`` clears. Full-copy paths are plain byte streams and are
sliced by the facade's own progress counter.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.crypto import TlsSession
from repro_torch.core.egress import libra_close, libra_send
from repro_torch.core.ingress import libra_recv
from repro_torch.core.parser import ParserPolicy
from repro_torch.core.state_machine import MIN_PAYLOAD, St
from repro_torch.core.stream import Connection
from repro_torch.core.vpi import VpiEntry, VpiRegistry


class Events(enum.IntFlag):
    """``poll()`` readiness bits (poll(2) analogue)."""
    NONE = 0
    READABLE = 1       # bytes waiting in the receive queue
    WRITABLE = 2       # a NEW message is accepted (no truncated send pending)
    SEND_PENDING = 4   # a budget-truncated message awaits continuation
    CLOSED = 8


@dataclasses.dataclass
class _PendingSend:
    """One in-flight outbound message on a TX socket."""
    src_conn: Connection      # connection whose RX anchored the payload
    msg: np.ndarray           # full outgoing buffer as first submitted
    logical: int              # total logical length of the message
    accepted: int = 0         # logical bytes accepted so far


class LibraSocket:
    """One proxied connection, POSIX surface. Construct via
    :meth:`LibraStack.socket` — the stack owns all shared state."""

    def __init__(self, stack, parser: ParserPolicy, *,
                 min_payload: int = MIN_PAYLOAD,
                 send_budget: Optional[int] = None,
                 tls: Optional[str] = None):
        self._stack = stack
        self.parser = parser
        self.send_budget = send_budget   # default per-call budget (None = ∞)
        self._conn = Connection(parser, stack.registry, min_payload=min_payload)
        # kTLS-analogue session (tls='sw'|'hw'): per-direction keys derive
        # from the stack's VPI-registry secret; the datapaths find the
        # session on the connection, the wire-side peers through ``.tls``
        self.tls: Optional[TlsSession] = None
        if tls is not None:
            self.tls = TlsSession(
                tls,
                stack.registry.derive_key(b"tls-rx", self._conn.conn_id),
                stack.registry.derive_key(b"tls-tx", self._conn.conn_id))
            self._conn.crypto = self.tls
        self._pending: Optional[_PendingSend] = None
        self._first_parse = None       # ParseResult handed to the first send
        self._parse_memo = None        # (queue fingerprint, ParseResult)
        # set by recv_batch when the auth sweep rejected this socket's
        # record (the batch drops the slot instead of raising); the
        # runtime reads-and-clears it to attribute the reject to a channel
        self._auth_rejected = False
        # set by recv_batch's fused L7 policy pass: the Verdict for the
        # message this socket delivered in the round; the runtime pops it
        # into the owning channel so routing skips the per-channel callbacks
        self._policy_verdict = None
        # set by the one-kernel fused round: the speculative TX descriptor
        # (gather output + hw-kTLS keystream spans) for the message this
        # socket delivered; forward_batch validates and consumes it
        self._fused_tx = None

    # -- identity / state ---------------------------------------------------
    def fileno(self) -> int:
        return self._conn.conn_id

    @property
    def closed(self) -> bool:
        return self._conn.closed

    @property
    def connection(self) -> Connection:
        """Escape hatch to the underlying connection (compat layer)."""
        return self._conn

    @property
    def stack(self):
        """The owning :class:`~repro_torch.core.stack.LibraStack`."""
        return self._stack

    @property
    def worker_id(self) -> Optional[int]:
        """The cluster worker this socket's stack lives on (None for a
        standalone stack)."""
        return self._stack.worker_id

    @property
    def pending_send(self) -> Optional[_PendingSend]:
        return self._pending

    def rx_available(self) -> int:
        return self._conn.rx_available()

    def parse_pending(self):
        """ParseResult for the current head of the receive queue — a pure
        function of the queue fingerprint, memoised so idle poll rounds and
        the batched datapath never rescan the window (KMP for delimiters)."""
        conn = self._conn
        key = conn.rx_fingerprint()
        if self._parse_memo is not None and self._parse_memo[0] == key:
            return self._parse_memo[1]
        res = self.parser.parse(conn.rx_window(self.parser.lookahead))
        self._parse_memo = (key, res)
        return res

    def needs_more_data(self) -> bool:
        """True when the buffered bytes are only the prefix of a message
        whose boundary the parser cannot locate yet (``need_more``). A raw
        ``recv`` would return these bytes (POSIX semantics); an L7 event
        loop uses this to wait for a parseable frame instead."""
        conn = self._conn
        if conn.closed or conn.rx_available() == 0:
            return False
        if conn.rx_drain_remaining > 0:
            return False
        if conn.rx_machine.state is not St.DEFAULT:
            return False
        res = self.parse_pending()
        return not res.ok and res.need_more

    def next_frame_selective(self) -> bool:
        """True when the pending frame would take the selective (anchoring)
        path on recv — the backpressure predicate: pausing such a socket
        sheds pool load; full-copy frames never touch the pool."""
        conn = self._conn
        if conn.closed or conn.rx_available() == 0 or conn.rx_drain_remaining:
            return False
        if conn.rx_machine.state is not St.DEFAULT:
            return False
        res = self.parse_pending()
        return res.ok and res.payload_len >= conn.rx_machine.min_payload

    def tx_wire(self) -> np.ndarray:
        return self._conn.tx_wire()

    def poll(self) -> Events:
        if self._conn.closed:
            return Events.CLOSED
        ev = Events.NONE
        if self._conn.rx_available() > 0:
            ev |= Events.READABLE
        if self._pending is not None:
            # send(new_buf) would raise EAGAIN: the bit and the call agree
            ev |= Events.SEND_PENDING
        else:
            ev |= Events.WRITABLE
        return ev

    # -- network side (NIC DMA analogue) ------------------------------------
    def deliver(self, data) -> None:
        """The network delivers bytes into this socket's receive queue.
        An installed :class:`~repro_torch.core.faults.FaultPlan` sees the bytes
        first (frame-aware corruption injection — the wire is the fault
        boundary; internal migrations use ``connection.deliver``)."""
        data = np.asarray(data, np.int64)
        plan = getattr(self._stack, "fault_plan", None)
        if plan is not None:
            data = plan.corrupt_ingress(self, data)
        self._conn.deliver(data)

    # -- POSIX surface -------------------------------------------------------
    def recv(self, buf_len: int) -> Tuple[np.ndarray, int]:
        """Instrumented recvmsg: returns ``(user_buffer, logical_len)``."""
        if self._conn.closed:
            raise OSError("recv on closed LibraSocket")
        buf, n = libra_recv(self._conn, buf_len, self._stack.pool,
                            self._stack.registry, self._stack.counters)
        if self._conn.anchored:
            self._stack._note_anchor_owner(self)
        return buf, n

    def send(self, buf=None, *, budget: Optional[int] = None) -> int:
        """Transmit on this socket; returns logical bytes accepted (like a
        non-blocking send). ``buf=None`` continues the pending message."""
        return self._transmit(None, buf, budget)

    def forward(self, dst: "LibraSocket", buf, *,
                budget: Optional[int] = None) -> int:
        """Proxy forwarding: a message received on ``self`` goes out on
        ``dst``; ``self`` is the connection that anchored the payload."""
        return dst._transmit(self, buf, budget)

    def close(self) -> int:
        """§A.4 safe teardown. Returns the number of anchors deferred into
        the grace period (freed by subsequent ``LibraStack.tick()``s)."""
        if self._conn.closed:
            return 0
        deferred = libra_close(self._conn, self._stack.pool,
                               self._stack.registry, self._stack.now_tick)
        self._stack._detach(self)
        return deferred

    # -- transmit core -------------------------------------------------------
    def _peek_message(self, msg: np.ndarray):
        """(meta_len, vpi, entry, parse_result): entry when ``msg`` is
        [metadata..., VPI] with a live registry entry, None otherwise. The
        ParseResult is returned so the egress machine can reuse it (parse
        is pure; the message is scanned once per send)."""
        res = self.parser.parse(msg)
        if res.ok and res.payload_len >= 0 and len(msg) >= res.meta_len + 1:
            vpi = VpiRegistry.from_token(int(msg[res.meta_len]))
            entry: Optional[VpiEntry] = self._stack.registry.peek(vpi)
            if entry is not None:
                return res.meta_len, vpi, entry, res
            return len(msg), vpi, None, res
        return len(msg), None, None, res

    def _transmit(self, src: Optional["LibraSocket"], buf,
                  budget: Optional[int],
                  payload_prefetched: Optional[np.ndarray] = None,
                  peeked=None) -> int:
        if self._conn.closed:
            raise OSError("send on closed LibraSocket")
        budget = self.send_budget if budget is None else budget
        p = self._pending
        if p is not None and buf is not None:
            # a new message while one is budget-truncated would silently
            # interleave frames; refuse like a full non-blocking send buffer
            raise BlockingIOError(
                "send buffer full: a budget-truncated message is pending; "
                "call send() with no buffer to continue it")
        if p is None:
            if buf is None:
                raise ValueError("send() without a buffer and no pending message")
            sm_prev = self._conn.tx_machine
            if sm_prev.state in (St.FALLBACK_BYPASS, St.METADATA_PARSED):
                # the facade frames messages: bypass/partial-metadata state
                # left over from a completed frame (stale VPI, or a header
                # whose payload never follows) must not swallow or corrupt
                # this new message. Raw byte-stream continuations stay on
                # the compat layer.
                sm_prev.reset()
            msg = np.asarray(buf, np.int64)
            # ``peeked`` lets the batched forwarder hand in the
            # _peek_message it already ran for prefetch eligibility
            meta_len, vpi, entry, parsed = (peeked if peeked is not None
                                            else self._peek_message(msg))
            if entry is None and vpi is not None:
                # the handle may be anchored on a peer worker: adopt it
                # through the cluster interconnect (zero-copy grant or the
                # counted one-copy fallback) and transmit the translated
                # message — a no-op for standalone stacks / garbage tokens
                adopted = self._stack._adopt_message(msg, vpi, parsed)
                if adopted is not None:
                    msg = adopted
                    meta_len, vpi, entry, parsed = self._peek_message(msg)
            src_conn = src._conn if src is not None else None
            if src_conn is None and vpi is not None:
                owner = self._stack._anchor_owner(vpi)
                src_conn = owner._conn if owner is not None else None
            if src_conn is None:
                # no live anchor owner (raw message, or a stale/torn-down
                # handle): cross-path cleanup must not touch any real RX
                # machine — aim it at the stack's inert null connection
                src_conn = self._stack._null_source()
            # logical length must mirror what THIS socket's TX machine will
            # do: it fast-paths (meta + anchored payload) only when the
            # payload clears its own admission threshold; otherwise the
            # frame is a plain byte buffer
            if entry is not None and \
                    entry.payload_len >= self._conn.tx_machine.min_payload:
                logical = meta_len + entry.payload_len
            else:
                logical = len(msg)
            p = self._pending = _PendingSend(src_conn, msg, logical)
            self._first_parse = parsed
        sm = self._conn.tx_machine
        # FAST_PATH resumes machine-side from the cumulative offset and needs
        # the full message; every other path is a plain byte stream.
        chunk = p.msg if sm.state is St.FAST_PATH else p.msg[p.accepted:]
        parsed = self._first_parse if p.accepted == 0 else None
        self._first_parse = None
        n = libra_send(p.src_conn, self._conn, chunk, self._stack.pool,
                       self._stack.registry, self._stack.counters,
                       send_budget=budget, parsed=parsed,
                       payload_prefetched=payload_prefetched,
                       pool_router=self._stack.pool_for_entry)
        p.accepted += n
        if p.accepted >= p.logical:
            self._pending = None
            self._stack._gc_anchor_owners()
        return n

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"LibraSocket(fd={self.fileno()}, parser={self.parser.name}, "
                f"rx={self.rx_available()}, closed={self.closed})")
