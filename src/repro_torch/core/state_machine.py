"""Per-connection RX/TX lifecycle state machines — the paper's Figures 4 & 5.

The kernel (device) data-plane action is determined by the *final* state a
single RX-/TX-Prog evaluation reaches (footnote 4 of the paper): transitions
such as DEFAULT → METADATA_PARSED → WRITE_VPI may all happen within one
recv()/send() evaluation if buffer space allows.

States (shared by both machines):
  DEFAULT          — parsing metadata; small payloads stay here (full copy)
  METADATA_PARSED  — metadata located, VPI doesn't fit yet (deferred)
  WRITE_VPI        — inject the 8-byte VPI after the metadata (RX only)
  FAST_PATH        — payload bypass active (selective copy running)
  FALLBACK_BYPASS  — TX: VPI lookup missed; skip parsing, full-copy until
                     the current message completes (footnote 5)
"""
from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional

from repro_torch.core.parser import ParseResult, ParserPolicy
from repro_torch.core.vpi import VPI_BYTES


class St(Enum):
    DEFAULT = 0
    METADATA_PARSED = 1
    WRITE_VPI = 2
    FAST_PATH = 3
    FALLBACK_BYPASS = 4


MIN_PAYLOAD = VPI_BYTES  # the ≥8-byte admission threshold (§3.2)


@dataclasses.dataclass
class RxDecision:
    """Data-plane action for one recv evaluation."""
    state: St
    copy_meta: int = 0        # metadata tokens to physically copy
    inject_vpi: bool = False
    skip_payload: int = 0     # payload tokens logically consumed, not copied
    full_copy: int = 0        # tokens copied via the native path


class RxStateMachine:
    """Mirrors the proxy's L7 parse state on the receive path (Fig. 4)."""

    def __init__(self, parser: ParserPolicy, min_payload: int = MIN_PAYLOAD,
                 vpi_slots: int = 1):
        self.parser = parser
        self.min_payload = min_payload
        self.vpi_slots = vpi_slots  # stream slots one VPI occupies (8 bytes)
        self.state = St.DEFAULT
        self.meta_len = 0
        self.payload_len = 0
        self.meta_copied = 0
        self.payload_consumed = 0
        self.vpi_written = False

    def reset(self) -> None:
        self.state = St.DEFAULT
        self.meta_len = self.payload_len = 0
        self.meta_copied = self.payload_consumed = 0
        self.vpi_written = False

    def on_recv(self, window, user_buf_space: int,
                parsed: Optional[ParseResult] = None) -> RxDecision:
        """Evaluate the machine for one recv call. ``window`` is the bounded
        lookahead over the socket queue; ``user_buf_space`` the free room in
        the application buffer (G2: arbitrary size). ``parsed`` lets the
        caller reuse a ParseResult it already computed for this window
        (parse() is pure, so the reuse is sound)."""
        if self.state == St.FAST_PATH:
            remaining = self.payload_len - self.payload_consumed
            return RxDecision(St.FAST_PATH, skip_payload=remaining)

        if self.state == St.DEFAULT:
            res: ParseResult = (parsed if parsed is not None
                                else self.parser.parse(window))
            if not res.ok:
                # unparseable or incomplete: native full-copy of what's there
                return RxDecision(St.DEFAULT, full_copy=min(len(window), user_buf_space))
            self.meta_len = res.meta_len
            self.payload_len = res.payload_len
            if 0 <= res.payload_len < self.min_payload:
                # short payload: stay DEFAULT, full copy (admission policy)
                return RxDecision(
                    St.DEFAULT, full_copy=min(res.meta_len + max(res.payload_len, 0),
                                              user_buf_space))
            self.state = St.METADATA_PARSED

        if self.state == St.METADATA_PARSED:
            need = self.meta_len - self.meta_copied + self.vpi_slots
            if user_buf_space < need:
                # copy as much metadata as fits; defer the VPI (Fig. 4 box 2)
                take = min(self.meta_len - self.meta_copied, user_buf_space)
                self.meta_copied += take
                return RxDecision(St.METADATA_PARSED, copy_meta=take)
            self.state = St.WRITE_VPI

        if self.state == St.WRITE_VPI:
            take = self.meta_len - self.meta_copied
            self.meta_copied = self.meta_len
            self.vpi_written = True
            self.state = St.FAST_PATH
            return RxDecision(St.WRITE_VPI, copy_meta=take, inject_vpi=True,
                              skip_payload=self.payload_len)
        raise AssertionError(self.state)

    def on_payload_consumed(self, n: int) -> None:
        self.payload_consumed += n

    def complete(self) -> bool:
        return (self.vpi_written
                and self.payload_consumed >= self.payload_len >= 0)


@dataclasses.dataclass
class TxDecision:
    state: St
    copy_meta: int = 0
    vpi: Optional[int] = None      # extracted VPI (FAST_PATH)
    full_copy: int = 0
    zero_copy_payload: int = 0     # anchored tokens ownership-transferred


class TxStateMachine:
    """Egress two-phase orchestration (Fig. 5): Pre-Send parse + VPI
    extraction, kernel action, Post-Send cumulative accounting."""

    def __init__(self, parser: ParserPolicy, resolve_vpi, min_payload: int = MIN_PAYLOAD,
                 vpi_slots: int = 1, vpi_torn_down=None):
        self.parser = parser
        self.resolve_vpi = resolve_vpi  # callable vpi -> entry | None
        self.vpi_torn_down = vpi_torn_down  # callable vpi -> bool (§A.4 grace)
        self.min_payload = min_payload
        self.vpi_slots = vpi_slots
        self.state = St.DEFAULT
        self.meta_len = 0
        self.payload_len = 0
        self.sent_cumulative = 0
        self.message_len = 0
        self.current_vpi: Optional[int] = None
        # composed [meta..., payload...] staged for transmission — kept
        # across budget-truncated sendmsg calls (the pending-skb analogue)
        self.staged_out = None

    def reset(self) -> None:
        self.state = St.DEFAULT
        self.meta_len = self.payload_len = 0
        self.sent_cumulative = 0
        self.message_len = 0
        self.current_vpi = None
        self.staged_out = None

    # -- Pre-Send ----------------------------------------------------------
    def pre_send(self, buf, extract_vpi,
                 parsed: Optional[ParseResult] = None) -> TxDecision:
        """``buf`` is the user's outgoing stream window; ``extract_vpi`` maps
        a buffer slice to the embedded 64-bit VPI (or None). ``parsed``
        reuses a ParseResult the caller already computed for ``buf``."""
        if self.state == St.FALLBACK_BYPASS:
            # skip parsing entirely (avoids KMP overhead — footnote 5)
            return TxDecision(St.FALLBACK_BYPASS, full_copy=len(buf))
        if self.state == St.FAST_PATH:
            return TxDecision(St.FAST_PATH, vpi=self.current_vpi,
                              zero_copy_payload=self.payload_len)

        res = parsed if parsed is not None else self.parser.parse(buf)
        if not res.ok:
            return TxDecision(St.DEFAULT, full_copy=len(buf))
        self.meta_len, self.payload_len = res.meta_len, res.payload_len
        self.message_len = res.meta_len + max(res.payload_len, 0)
        if 0 <= res.payload_len < self.min_payload:
            return TxDecision(St.DEFAULT, full_copy=self.message_len)
        if len(buf) < res.meta_len + self.vpi_slots:
            self.state = St.METADATA_PARSED
            return TxDecision(St.METADATA_PARSED, copy_meta=res.meta_len)
        vpi = extract_vpi(buf, res.meta_len)
        entry = self.resolve_vpi(vpi) if vpi is not None else None
        if entry is None:
            if (vpi is not None and self.vpi_torn_down is not None
                    and self.vpi_torn_down(vpi)):
                # the handle was real but its payload entered the §A.4 grace
                # period (anchoring socket closed before this send): the
                # frame is all that remains — transmit it and complete,
                # never waiting for payload bytes that cannot arrive
                self.state = St.FALLBACK_BYPASS
                self.message_len = len(buf)
                return TxDecision(St.FALLBACK_BYPASS, full_copy=len(buf))
            self.state = St.FALLBACK_BYPASS  # cache miss (Fig. 5)
            return TxDecision(St.FALLBACK_BYPASS, full_copy=len(buf))
        self.current_vpi = vpi
        self.state = St.FAST_PATH
        return TxDecision(St.FAST_PATH, copy_meta=res.meta_len, vpi=vpi,
                          zero_copy_payload=self.payload_len)

    # -- Post-Send ----------------------------------------------------------
    def post_send(self, actually_sent: int) -> bool:
        """Cumulative accounting in all states except DEFAULT; returns True
        when the message completed (triggers cross-path cleanup)."""
        if self.state == St.DEFAULT:
            return False
        self.sent_cumulative += actually_sent
        if self.message_len and self.sent_cumulative >= self.message_len:
            self.reset()
            return True
        return False
