"""Egress datapath — §3.4: payload reassembly with L7 state synchronisation.

``libra_send`` wraps the instrumented sendmsg with the two-phase eBPF
orchestration:

  Pre-Send  : parse new metadata, extract + resolve the embedded VPI
              (map hit -> FAST_PATH; miss -> FALLBACK_BYPASS)
  Data plane: copy only the new metadata; transfer ownership of the
              anchored pages into the egress stream (two-phase staging,
              §A.2/§A.3 — no payload bytes move)
  Post-Send : cumulative byte accounting (non-blocking partial sends);
              on completion, delete the VPI entry, free pages (refcount,
              §A.4) and reset BOTH state machines (cross-datapath cleanup)

Encrypted destinations (``dst_conn.crypto`` set — the kTLS analogue)
re-encrypt outbound records under the transmitting socket's TX key: the
inner metadata is sealed during the metadata copy, and the payload cipher
is either a separate encrypt-and-copy pass after the gather (``sw`` mode,
§B.1's software penalty, counted in ``CopyCounters.crypto_copied``) or
fused into the gather itself (``hw`` mode — the NIC consumes plaintext
pages and encrypts inline, zero extra passes). The §A.2 staging window now
brackets the payload compose, so a failure between extract and commit
aborts the transfer instead of leaving the §A.3 budget raised forever.

Multi-worker routing: a VPI entry may be a **cross-worker grant** — the
payload lives in ANOTHER worker's pool. ``pool_router`` (supplied by the
socket facade) maps an entry to the pool that actually owns its pages, so
the §A.2 staging, the payload gather, and the final frees all run against
the owning allocator. Grant completion forwards teardown back to the
owner's registry (releasing the owner entry when it is still live; an
owner already inside its §A.4 grace period keeps its own deferred-free
schedule — the grant's pin reference is what kept the pages alive). The
one-copy fallback entries instead carry the payload in ``entry.stash`` and
touch no pool at all.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.anchor_pool import PageRef
from repro_torch.core.crypto import REC_HEADER, record_header
from repro_torch.core.ingress import reset_rx_from_tx
from repro_torch.core.state_machine import St
from repro_torch.core.stream import Connection, CopyCounters, TokenPool
from repro_torch.core.sync import plane_lock
from repro_torch.core.vpi import VpiRegistry


def _extract_vpi(buf: np.ndarray, meta_len: int) -> Optional[int]:
    """The VPI occupies the single int64 slot right after the metadata."""
    if len(buf) < meta_len + 1:
        return None
    v = VpiRegistry.from_token(int(buf[meta_len]))
    return v if v != 0 else None


def _tx_full_copy_crypt(crypto, buf: np.ndarray,
                        chunk: np.ndarray) -> np.ndarray:
    """Encrypt a full-copy TX chunk of a record frame (fallback/bypass/
    short-payload paths). The session tracks (seq, position, end) across
    budget-truncated calls so the keystream resumes mid-record; frames that
    do not start with a record header pass through raw (with the same
    continuation tracking, so a later record is never mistaken for one)."""
    if crypto.tx_resume is None:
        hdr = record_header(buf)
        seq = hdr[0] if hdr is not None else None
        pos, end = 0, len(buf)
    else:
        seq, pos, end = crypto.tx_resume
    out = crypto.tx_encrypt_span(chunk, seq, pos) if seq is not None else chunk
    pos += len(chunk)
    crypto.tx_resume = (seq, pos, end) if pos < end else None
    return out


def libra_send(
    src_conn: Connection,
    dst_conn: Connection,
    buf: np.ndarray,
    pool: TokenPool,
    registry: VpiRegistry,
    counters: CopyCounters,
    send_budget: Optional[int] = None,
    parsed=None,
    payload_prefetched: Optional[np.ndarray] = None,
    pool_router=None,
) -> int:
    """Transmit the proxy's outgoing buffer [new_metadata..., VPI] on
    ``dst_conn``. Returns the number of *logical* bytes accepted (like a
    non-blocking send). ``send_budget`` models a constrained send buffer;
    ``parsed`` reuses a ParseResult already computed for ``buf``;
    ``payload_prefetched`` hands in this message's anchored payload when a
    batched forward already gathered it (one fused read for the round) —
    it MUST be the exact payload bytes this socket would compose itself
    (``read_payload`` output, with the TX keystream already fused for an
    encrypted hw-mode destination). ``pool_router`` (entry -> TokenPool)
    resolves the pool that owns an entry's pages — cross-worker grant
    entries route to the owning worker's pool; None keeps everything on
    ``pool`` (single-stack behaviour).
    """
    sm = dst_conn.tx_machine
    crypto = dst_conn.crypto
    decision = sm.pre_send(buf, _extract_vpi, parsed=parsed)

    if decision.state in (St.DEFAULT, St.FALLBACK_BYPASS, St.METADATA_PARSED):
        n = len(buf) if send_budget is None else min(len(buf), send_budget)
        chunk = np.asarray(buf[:n]).copy()
        if crypto is not None and n:
            chunk = _tx_full_copy_crypt(crypto, buf, chunk)
        dst_conn.tx_stream.append(chunk)
        counters.full_copied += n
        if decision.state != St.DEFAULT:
            done = sm.post_send(n)
            if done:
                reset_rx_from_tx(src_conn)
        return n

    assert decision.state == St.FAST_PATH
    # cumulative resume offset: a budget-constrained send picks the message
    # up where the previous call left off (Post-Send accounting, §3.4)
    start = sm.sent_cumulative
    entry = registry.resolve(decision.vpi)
    if entry is None:
        # only reachable on a resume: the anchoring socket closed mid-send
        # (§A.4 moved the entry to TEARDOWN and deferred the page frees).
        # The staged frame completes the transmission; teardown expiry owns
        # the pages now, so the done-cleanup below must not free them.
        assert start > 0 and sm.staged_out is not None, decision.vpi
        owned = None
        data_pool = pool
    else:
        # cross-worker grant entries name another worker's pool: stage,
        # gather and free against the pool that owns the pages
        data_pool = pool_router(entry) if pool_router is not None else pool
        owned = [PageRef(*pg) for pg in entry.pages]
        if start == 0:
            meta = np.asarray(buf[: sm.meta_len]).copy()
            # §A.2 two-phase ownership transfer through the staging list;
            # the payload compose sits INSIDE the stage->commit window so a
            # failure aborts the transfer (restoring the §A.3 budget raise)
            # instead of leaving it elevated forever. For a cross-worker
            # grant entry, data_pool is the OWNING worker's pool and this
            # code may run from the destination worker's quantum — the
            # whole stage->commit window holds the cluster-plane lock
            # (a no-op single-stack; see repro_torch.core.sync).
            with plane_lock(data_pool.alloc):
                staged = data_pool.alloc.stage_transfer(owned)
                try:
                    if crypto is not None:
                        seq = int(meta[1])
                        imeta = len(meta) - REC_HEADER
                        meta = crypto.seal_meta(meta)
                    # zero-copy "transmission": the NIC consumes anchored
                    # pages in place; the composed frame stays staged
                    # across partial sends. A one-copy cross-worker entry
                    # already carries its payload (entry.stash) — the pool
                    # is never consulted.
                    raw = (np.asarray(entry.stash, np.int64)
                           if entry.stash is not None else None)
                    if payload_prefetched is not None:
                        payload = payload_prefetched
                    elif crypto is None:
                        payload = raw if raw is not None else \
                            data_pool.read_payload(owned, entry.payload_len)
                    elif crypto.mode == "hw":
                        # hw-kTLS: the TX cipher rides the gather — the NIC
                        # encrypts inline while consuming the anchored pages
                        ks = crypto.tx_payload_keystream(
                            seq, imeta, entry.payload_len)
                        payload = (np.bitwise_xor(raw, ks)
                                   if raw is not None
                                   else data_pool.read_payload(
                                       owned, entry.payload_len,
                                       keystream=ks))
                    else:
                        # sw-kTLS: encrypt-and-copy re-touches the gathered
                        # payload in a separate pass (§B.1)
                        payload = raw if raw is not None else \
                            data_pool.read_payload(owned, entry.payload_len)
                        payload = crypto.sw_encrypt_payload(seq, imeta,
                                                            payload)
                        counters.crypto_copied += entry.payload_len
                except BaseException:
                    data_pool.alloc.abort_transfer(staged)
                    raise
                owned = data_pool.alloc.commit_transfer(staged)
            # data plane: selective copy of the new metadata only (counted
            # after the commit so an aborted compose, retried later, does
            # not double-charge the copy telemetry)
            counters.meta_copied += len(meta)
            counters.zero_copied += entry.payload_len
            sm.staged_out = np.concatenate([meta, payload])
    out = sm.staged_out

    remaining = len(out) - start
    n = remaining if send_budget is None else min(remaining, send_budget)
    dst_conn.tx_stream.append(out[start : start + n])

    if sm.post_send(n):
        # cross-datapath cleanup: VPI entry out of the global map, pages
        # refcount-released, RX machine of the source connection reset.
        # A cross-worker completion mutates BOTH the destination registry
        # and the owner's registry/pool, possibly from the source worker's
        # quantum — the whole cleanup holds the cluster-plane lock.
        grant = entry.grant if entry is not None else None
        with plane_lock(registry):
            if owned is not None and registry.release(decision.vpi):
                if grant is not None:
                    # drop the grant's pin ref on the owning worker's pool,
                    # then forward the completion to the owner: a
                    # still-live owner entry gets the exact single-stack
                    # cleanup (entry released, original page ref dropped);
                    # an owner already in — or past — its §A.4 grace
                    # period keeps its deferred-free schedule (the expiry
                    # drops the original ref, we only dropped ours)
                    data_pool.alloc.release_export(owned)
                    oreg, ovpi = grant.owner_registry, grant.owner_vpi
                    if oreg.peek(ovpi) is not None and oreg.release(ovpi):
                        data_pool.alloc.free_pages_list(owned)
                    src_conn.anchored.pop(ovpi, None)
                else:
                    data_pool.alloc.free_pages_list(owned)
        src_conn.anchored.pop(decision.vpi, None)
        reset_rx_from_tx(src_conn)
    return n


def libra_close(
    conn: Connection,
    pool: TokenPool,
    registry: VpiRegistry,
    now_tick: int,
) -> int:
    """§A.4 safe teardown: if payloads are still anchored when the socket
    closes, defer the free by a grace period instead of dangling."""
    conn.closed = True
    deferred = 0
    # membership check → teardown+defer is one atomic region (a threaded
    # peer completing a grant forward could drop the entry in between)
    with plane_lock(registry):
        for vpi, (pages, _ln) in list(conn.anchored.items()):
            if vpi in registry:
                registry.begin_teardown(vpi, now_tick)
                pool.alloc.defer_free(pages, now_tick + registry.grace_ticks)
                deferred += 1
            conn.anchored.pop(vpi, None)
    return deferred


def expire_teardowns(pool: TokenPool, registry: VpiRegistry, now_tick: int) -> int:
    """Periodic tick: release grace-period-expired anchors (§A.4)."""
    with plane_lock(registry):
        registry.expire_teardowns(now_tick)
    with plane_lock(pool.alloc):
        return pool.alloc.expire_deferred(now_tick)
