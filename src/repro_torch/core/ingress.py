"""Ingress datapath — §3.3: state-driven selective copy.

``libra_recv`` is the instrumented recvmsg: the RX state machine (eBPF
RX-Prog analogue) decides, per call, which data-plane action runs:

  DEFAULT          -> native full copy (unparseable / short payload)
  METADATA_PARSED  -> copy only metadata; defer VPI (no buffer space)
  WRITE_VPI        -> copy remaining metadata, anchor payload, inject VPI
  FAST_PATH        -> advance the logical read offset; copy nothing

The returned length is the *logical* message length (metadata + anchored
payload), capped at the requested size — recv transparency (§3.3 box 3).
The RX machine stays in FAST_PATH until the egress path confirms full
transmission and resets it (cross-datapath cleanup, §3.4 box 3).

Pool exhaustion follows §A.1: the prefix that fits is anchored zero-copy;
the remainder is served through the native full-copy path.

Encrypted connections (``Connection.crypto`` set — the kTLS analogue) run
the same machine over ciphertext records: the record header + inner
metadata are decrypted during the metadata copy, and the payload cipher is
either a separate decrypt-and-copy pass before anchoring (``sw`` mode,
§B.1's software kTLS penalty, counted in ``CopyCounters.crypto_copied``)
or fused into the anchoring scatter itself (``hw`` mode, the NIC-inline
datapath — zero extra passes). Full-copy fallbacks (short records, §A.1
drain) decrypt in place so the application always sees plaintext.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.anchor_pool import PoolExhausted
from repro_torch.core.crypto import REC_HEADER, TAG_SLOT, RecordAuthError, xor_tokens
from repro_torch.core.state_machine import St
from repro_torch.core.stream import Connection, CopyCounters, TokenPool
from repro_torch.core.sync import plane_lock
from repro_torch.core.vpi import VpiRegistry


def libra_recv(
    conn: Connection,
    buf_len: int,
    pool: TokenPool,
    registry: VpiRegistry,
    counters: CopyCounters,
) -> Tuple[np.ndarray, int]:
    """Returns (user_visible_buffer, logical_length).

    On the selective-copy path the buffer contains [metadata..., VPI] while
    the logical length covers metadata + anchored payload.
    """
    sm = conn.rx_machine
    crypto = conn.crypto

    # §A.1 drain mode: a previous message overflowed the pool; the rest of
    # its payload takes the native copy path.
    drain = conn.rx_drain_remaining
    if drain > 0:
        n = min(drain, conn.rx_available(), buf_len)
        out = conn.rx_peek(n).copy()
        conn.rx_advance(n)
        counters.full_copied += n
        conn.rx_drain_remaining = drain - n
        if crypto is not None and crypto.rx_drain is not None and n:
            # the drained ciphertext resumes its record keystream where the
            # previous call stopped (offsets are encrypted-region positions)
            seq, off = crypto.rx_drain
            out = xor_tokens(out, crypto.rx_payload_keystream(seq, 0, n, off))
            crypto.rx_drain = ((seq, off + n)
                               if conn.rx_drain_remaining else None)
        if conn.rx_drain_remaining == 0:
            sm.reset()
        return out, n

    window = conn.rx_window(sm.parser.lookahead)
    if len(window) == 0 and not (sm.state == St.FAST_PATH
                                 and sm.payload_consumed < sm.payload_len):
        # nothing buffered AND no capped logical remainder to report: the
        # FAST_PATH skip needs no rx bytes (the kernel already consumed the
        # skb at WRITE_VPI) — recv transparency must still surface it
        return np.zeros((0,), np.int64), 0

    parsed = None
    if sm.state == St.DEFAULT:
        # admission precondition for the selective path: the whole declared
        # payload must be resident in the kernel queue (NIC DMA complete)
        # before anchoring — a partially delivered message waits, it is
        # never anchored with holes. (parse() is pure; the result is reused
        # by the state machine below, so the window is scanned once.)
        parsed = sm.parser.parse(window)
        if parsed.ok and parsed.payload_len >= sm.min_payload \
                and conn.rx_available() < parsed.meta_len + parsed.payload_len:
            return np.zeros((0,), np.int64), 0
    # the window view may be invalidated by rx_advance below; capture the
    # record seq while it is still valid
    head_seq = int(window[1]) if len(window) >= 2 else None

    decision = sm.on_recv(window, buf_len, parsed=parsed)

    if decision.state == St.DEFAULT:
        n = min(decision.full_copy, conn.rx_available(), buf_len)
        out = conn.rx_peek(n).copy()
        if crypto is not None and parsed is not None and parsed.ok and n:
            # a short-payload record served through the native path: the
            # record layer verifies the WHOLE resident record BEFORE any
            # of its plaintext reaches the caller — including tiny-buffer
            # calls that serve only a prefix (a record whose payload has
            # not fully arrived yet serves unverified, the same streaming
            # corner as split metadata; the wire-side open still checks)
            whole = parsed.meta_len + parsed.payload_len
            if conn.rx_available() >= whole:
                rec = crypto.rx_open_span(conn.rx_peek(whole), head_seq, 0)
                if not crypto.verify_record(head_seq, rec[TAG_SLOT],
                                            rec[REC_HEADER:]):
                    # tag mismatch: reject — consume the record, deliver
                    # nothing, charge nothing
                    conn.rx_advance(whole)
                    sm.reset()
                    raise RecordAuthError(
                        f"record seq={head_seq}: tag mismatch")
                out = rec[:n].copy()
            else:
                out = crypto.rx_open_span(out, head_seq, 0)
        conn.rx_advance(n)
        counters.full_copied += n
        sm.reset()
        return out, n

    if decision.state == St.METADATA_PARSED:
        n = decision.copy_meta
        out = conn.rx_peek(n).copy()
        conn.rx_advance(n)
        counters.meta_copied += n
        if crypto is not None and n:
            start = sm.meta_copied - n
            if start == 0:
                # remember the record seq: continuations of this metadata
                # span no longer see the header
                crypto.rx_meta_seq = head_seq
            if crypto.rx_meta_seq is not None:
                out = crypto.rx_open_span(out, crypto.rx_meta_seq, start)
        return out, n

    if decision.state == St.WRITE_VPI:
        meta = conn.rx_peek(decision.copy_meta).copy()
        payload_len = sm.payload_len
        seq = None
        imeta = sm.meta_len - REC_HEADER
        # plaintext produced by the auth verify, reused by the decrypt
        # below so no record pays the cipher twice
        verified_plain = None
        if crypto is not None:
            start = sm.meta_len - decision.copy_meta
            seq = head_seq if start == 0 else crypto.rx_meta_seq
            crypto.rx_meta_seq = None
            if seq is not None:
                meta = crypto.rx_open_span(meta, seq, start)
                if start == 0:
                    # per-record auth, BEFORE anything is consumed or
                    # anchored: the record-layer verify (sw's decrypt pass
                    # and hw's fused scatter both run after — and only
                    # if — the tag checks out). The tag covers the whole
                    # plaintext record, so metadata spans split across
                    # several tiny-buffer recv calls (start > 0) cannot be
                    # checked inline and pass through (the §3.3
                    # deferred-VPI corner; the wire-side open still
                    # verifies).
                    ks = crypto.rx_payload_keystream(seq, imeta, payload_len)
                    plain = xor_tokens(
                        conn.rx_peek(sm.meta_len + payload_len)[sm.meta_len:],
                        ks)
                    if not crypto.verify_record(
                            seq, meta[TAG_SLOT],
                            np.concatenate([meta[REC_HEADER:], plain])):
                        conn.rx_advance(sm.meta_len + payload_len)
                        sm.reset()
                        raise RecordAuthError(
                            f"record seq={seq}: tag mismatch")
                    verified_plain = plain
                crypto.stats["records_opened"] += 1
        conn.rx_advance(decision.copy_meta)
        counters.meta_copied += len(meta)
        # zero-copy window over the resident payload (view stays valid
        # until the rx_advance below)
        payload = conn.rx_peek(payload_len)
        try:
            with plane_lock(pool.alloc):
                pages = pool.alloc.alloc_sequence(payload_len)
        except PoolExhausted:
            # anchor nothing; serve the whole payload via native copies.
            # the metadata was already accounted as meta_copied above — only
            # the payload portion goes through the full-copy path. (clamp to
            # what is actually buffered: never advance past delivered bytes)
            n = (min(payload_len, conn.rx_available(), buf_len - len(meta))
                 if buf_len > len(meta) else 0)
            served = payload[:n].copy()
            if seq is not None and n:
                served = (verified_plain[:n] if verified_plain is not None
                          else xor_tokens(
                              served,
                              crypto.rx_payload_keystream(seq, imeta, n)))
            out = np.concatenate([meta, served])
            conn.rx_advance(n)
            counters.full_copied += n
            conn.rx_drain_remaining = payload_len - n
            if crypto is not None:
                crypto.rx_drain = ((seq, imeta + n) if seq is not None
                                   and conn.rx_drain_remaining else None)
            if conn.rx_drain_remaining == 0:
                sm.reset()
            return out, len(out)
        try:
            if seq is None:
                pool.write_payload(pages, payload)
            elif crypto.mode == "sw":
                # sw-kTLS: decrypt-and-copy into a fresh buffer, THEN
                # anchor — the separate pass the paper's §B.1 software path
                # cannot avoid. The verify already produced the plaintext
                # buffer; it IS that pass (counted as such) — never run the
                # cipher twice.
                if verified_plain is not None:
                    plain = verified_plain
                    crypto.stats["sw_decrypt_passes"] += 1
                else:
                    plain = crypto.sw_decrypt_payload(seq, imeta, payload)
                counters.crypto_copied += payload_len
                pool.write_payload(pages, plain)
            elif verified_plain is not None:
                # hw-kTLS: the NIC verified and decrypted in the same
                # pass — anchor the plaintext the verify produced (one
                # cipher pass total; the keystream-fused scatter below
                # serves the rare unverified continuation case)
                pool.write_payload(pages, verified_plain)
            else:
                # hw-kTLS: the cipher rides the anchoring scatter itself —
                # the ciphertext is decrypted exactly once, on the fly
                pool.write_payload(
                    pages, payload,
                    keystream=crypto.rx_payload_keystream(
                        seq, imeta, payload_len))
            counters.anchored += payload_len
            counters.allocs += 1
            conn.rx_advance(payload_len)
            with plane_lock(registry):
                vpi = registry.register(
                    pool.pool_id,
                    [(p.shard, p.local_pid, p.base_pos) for p in pages],
                    payload_len,
                )
        except BaseException:
            # the pages are ours until the registry owns them: a datapath
            # fault between alloc and register hands them straight back to
            # the freelist instead of leaking them (OWN001)
            with plane_lock(pool.alloc):
                pool.alloc.free_pages_list(pages)
            raise
        conn.anchored[vpi] = (pages, payload_len)
        out = np.concatenate([meta, np.array([VpiRegistry.to_token(vpi)], np.int64)])
        counters.vpi_injected += 1
        logical = min(len(meta) + payload_len, buf_len)
        sm.on_payload_consumed(logical - len(meta))
        return out, logical

    if decision.state == St.FAST_PATH:
        # remaining logical length, zero physical copies
        n = min(decision.skip_payload, buf_len)
        sm.on_payload_consumed(n)
        return np.zeros((0,), np.int64), n

    raise AssertionError(decision.state)


def reset_rx_from_tx(conn: Connection) -> None:
    """Cross-datapath cleanup: called by the egress path once the anchored
    payload has been fully transmitted (§3.4 Post-Send)."""
    conn.rx_machine.reset()
