"""Stream-level substrate for the Libra core: connections + token payload pool.

This is the protocol-agnostic layer the paper's Figure 3(b) describes,
expressed over int64 token streams (1 token = 8 bytes, so a VPI occupies
exactly one stream slot). The serving engine reuses the same machinery with
KV pages as the anchored payload; this layer anchors raw token payloads so
the core can be tested and benchmarked in isolation.

Datapath invariants kept allocation-free:

* :class:`RxRing` — the receive queue is an amortized growable ring, not a
  reallocate-on-every-deliver array: ``push`` appends into spare tail
  capacity, the dead prefix is reclaimed by sliding (never by reallocating)
  once it dominates the live region, and ``peek``/``window`` hand out
  zero-copy views.
* :class:`TokenPool` — payload placement/readback are single reshaped
  scatter/gather ops (no per-page Python loop), with batched variants that
  fuse a whole recv/forward round into one indexed assignment, tiled
  adaptively by live footprint (:meth:`TokenPool.batch_tile`). The pool
  carries the one scratch row :attr:`AnchorPool.scratch_page` reserves so
  the fused device kernel needs no per-call pool copy. The device-resident
  variant (:class:`repro_torch.core.device_pool.DevicePool`, the stack default)
  keeps the pool on the device across batched rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.anchor_pool import AnchorPool, PageRef
from repro_torch.core.parser import ParserPolicy
from repro_torch.core.state_machine import RxStateMachine, St, TxStateMachine
from repro_torch.core.vpi import VpiRegistry
from repro_torch.kernels.ops import checked_device


class RxRing:
    """Amortized growable receive ring (the skb queue analogue).

    Tokens live in ``_buf[_head:_tail]``. ``push`` writes into the spare
    tail; when the tail hits capacity the live region slides to the front
    (reclaiming the dead prefix) and the buffer only reallocates — by
    doubling — when the live data itself outgrows it. ``advance`` also
    compacts once the dead prefix exceeds the live region (proportional
    policy: no fixed 64Ki threshold, so small-queue workloads never retain
    dead prefixes indefinitely; tune with ``min_compact``).

    ``peek``/views are zero-copy and remain valid until the next
    ``push``/``advance`` on this ring (both may slide the buffer).
    """

    __slots__ = ("_buf", "_head", "_tail", "consumed", "delivered",
                 "min_compact")

    def __init__(self, capacity: int = 256, min_compact: int = 64):
        self._buf = np.zeros((max(capacity, 16),), np.int64)
        self._head = 0
        self._tail = 0
        self.consumed = 0    # total tokens ever advanced past (monotonic)
        self.delivered = 0   # total tokens ever pushed (monotonic)
        self.min_compact = min_compact

    def __len__(self) -> int:
        return self._tail - self._head

    @property
    def capacity(self) -> int:
        return len(self._buf)

    def _slide(self) -> None:
        live = self._tail - self._head
        # numpy slice assignment buffers overlapping copies (>= 1.13)
        self._buf[:live] = self._buf[self._head : self._tail]
        self._head, self._tail = 0, live

    def push(self, data: np.ndarray) -> None:
        n = len(data)
        if n == 0:
            return
        if self._tail + n > len(self._buf):
            live = self._tail - self._head
            if live + n > len(self._buf):
                grown = np.zeros((max(len(self._buf) * 2, live + n),), np.int64)
                grown[:live] = self._buf[self._head : self._tail]
                self._buf = grown
                self._head, self._tail = 0, live
            else:
                self._slide()
        self._buf[self._tail : self._tail + n] = data
        self._tail += n
        self.delivered += n

    def peek(self, n: int) -> np.ndarray:
        """Zero-copy view of up to ``n`` buffered tokens."""
        return self._buf[self._head : min(self._head + n, self._tail)]

    def advance(self, n: int) -> None:
        assert self._head + n <= self._tail, (n, len(self))
        self._head += n
        self.consumed += n
        # proportional compaction: reclaim once the dead prefix dominates
        # the live region (each token moves at most O(1) times, amortized)
        if self._head >= self.min_compact and self._head > self._tail - self._head:
            self._slide()

    def fingerprint(self) -> Tuple[int, int]:
        """Content-stable identity of the unread region (survives slides/
        reallocations — used to memoise pure functions of the queue)."""
        return (self.consumed, self.delivered)


class TokenPool:
    """Device-side payload pool stand-in: [n_shards * pages_per_shard, page]
    int64 pages. Payload tokens are written once on ingress (DMA analogue)
    and never moved again.

    The backing array carries one extra row — the scratch page the fused
    selective-copy kernel routes dummy DMAs to (``alloc.scratch_page``) —
    so device dispatch never has to extend the pool per call.

    ``device`` is where device-impl rounds run (``"cuda"`` by default;
    the CPU tests pass ``"cpu"``). Nothing touches it until such a round."""

    def __init__(self, alloc: AnchorPool, device="cuda"):
        self.alloc = alloc
        self.device = device
        # registry pool-id this pool's anchors are registered under; a
        # multi-worker cluster renames each worker's pool so grant entries
        # can name (and egress can route to) the owning worker's pool
        self.pool_id = "token-pool"
        total = alloc.n_shards * alloc.pages_per_shard
        self._flat = np.zeros((total + 1, alloc.page_size), np.int64)
        # real pages view: writes through to the same storage
        self._data_view = self._flat[:total].reshape(
            alloc.n_shards, alloc.pages_per_shard, alloc.page_size)
        # host<->device traffic telemetry (tokens). ``pool_syncs`` counts
        # O(pool)-sized boundary crossings — the failure mode the resident
        # :class:`~repro_torch.core.device_pool.DevicePool` eliminates; this host
        # pool pays one per device-impl round (see anchor_batch_device).
        self.xfer: Dict[str, int] = {"h2d_tokens": 0, "d2h_tokens": 0,
                                     "pool_syncs": 0, "device_rounds": 0,
                                     "resident_init_tokens": 0,
                                     # ingress (anchoring) device rounds,
                                     # and how many of them verifiably
                                     # consumed the donated input pool
                                     # buffer (outer-jit donate_argnums —
                                     # exactly one pool allocation stays
                                     # live per round): donated == anchor
                                     # on backends that honour donation
                                     # (CPU/TPU do)
                                     "anchor_rounds": 0,
                                     "donated_rounds": 0,
                                     # one-kernel rounds: fused_rounds
                                     # counts single-launch scheduling
                                     # rounds (anchor + crypto + policy +
                                     # gather in ONE device_rounds bump);
                                     # policy_match_rounds counts the
                                     # standalone device match launches
                                     # the fused path eliminates
                                     "fused_rounds": 0,
                                     "policy_match_rounds": 0,
                                     # forward_batch consumed a fused
                                     # round's speculative TX gather
                                     # output (no gather launch needed)
                                     "tx_spec_hits": 0}

    def torch_device(self) -> torch.device:
        """The device of this pool's device rounds (raises when it names a
        CUDA device and no GPU is present)."""
        return checked_device(self.device)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host operand as an int32 tensor on the pool's device."""
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.torch_device())

    @property
    def data(self) -> np.ndarray:
        """[n_shards, pages_per_shard, page] view of the host pool (writes
        through to the same storage)."""
        return self._data_view

    @property
    def flat_with_scratch(self) -> np.ndarray:
        """[total_pages + 1, page] flat view; row ``alloc.scratch_page`` is
        the reserved kernel scratch row (contents undefined)."""
        return self._flat

    def _page_coords(self, pages: Sequence[PageRef], length: int,
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(dest flat indices, source payload positions) for every in-range
        token of ``pages`` — one vectorized index computation, no per-page
        loop on the data itself."""
        ps = self.alloc.page_size
        pps = self.alloc.pages_per_shard
        coords = np.array([(pg.shard * pps + pg.local_pid, pg.base_pos)
                           for pg in pages], np.int64).reshape(-1, 2)
        off = np.arange(ps)
        src = coords[:, 1:] + off[None, :]            # [n_pages, ps]
        mask = src < length
        dest = coords[:, :1] * ps + off[None, :]
        return dest[mask], src[mask]

    def write_payload(self, pages: List[PageRef], payload: np.ndarray,
                      keystream: Optional[np.ndarray] = None) -> None:
        """Anchor a payload with one reshaped scatter. ``keystream`` fuses
        the kTLS-analogue hw-mode cipher into that same pass: the XOR runs
        on the gathered values inside the placement (no decrypted copy of
        the payload ever exists outside the pool)."""
        n = len(payload)
        if n == 0 or not pages:
            return
        dest, src = self._page_coords(pages, n)
        vals = np.asarray(payload)[src]
        if keystream is not None:
            vals = np.bitwise_xor(vals, np.asarray(keystream)[src])
        self._flat.reshape(-1)[dest] = vals

    def read_payload(self, pages: List[PageRef], length: int,
                     keystream: Optional[np.ndarray] = None) -> np.ndarray:
        """Gather an anchored payload in one pass; ``keystream`` fuses the
        hw-mode TX cipher into the gather (the NIC-inline encrypt)."""
        out = np.zeros((length,), np.int64)
        if length and pages:
            dest, src = self._page_coords(pages, length)
            vals = self._flat.reshape(-1)[dest]
            if keystream is not None:
                vals = np.bitwise_xor(vals, np.asarray(keystream)[src])
            out[src] = vals
        return out

    # -- batched data plane (one fused pass per scheduling round) -----------

    #: bytes of cache one scatter/gather tile aims to stay inside: a tile's
    #: live footprint (page values + the int32 index temporaries, ~16 bytes
    #: per token) should remain L2-resident while it is built and consumed.
    #: The tile size adapts to the round's actual message footprint instead
    #: of a hardcoded message count (tiny messages fuse by the thousand,
    #: page-heavy ones fall back to small tiles).
    cache_budget = 1 << 20

    def tile_for_footprint(self, n_pages: int, n_msgs: int,
                           cap: int = 4096) -> int:
        """The one footprint→tile policy (shared by the pool's internal
        scatter/gather tiling and the runtime's round tiling): messages
        per tile such that one tile's pages stay inside
        :attr:`cache_budget` at ~16 bytes/token."""
        if n_msgs == 0 or n_pages == 0:
            return max(n_msgs, 1)
        per_msg = max(n_pages / n_msgs, 1.0) * self.alloc.page_size * 16
        return int(np.clip(self.cache_budget // per_msg, 1, cap))

    def batch_tile(self, seqs: Sequence[Tuple[Sequence[PageRef], object]],
                   ) -> int:
        """Messages fused per scatter/gather tile, sized from the round's
        live footprint (``pages × page_size`` per message vs
        :attr:`cache_budget`)."""
        return self.tile_for_footprint(
            sum(len(pages) for pages, _ in seqs), len(seqs))

    def _batch_coords(self, seqs: Sequence[Tuple[Sequence[PageRef], int]],
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(dest flat pool indices, positions in the concatenated payload
        stream) for every in-range token of a batch — one pass over the
        page lists, then pure vectorized (int32) indexing."""
        ps = self.alloc.page_size
        pps = self.alloc.pages_per_shard
        lens = np.array([ln for _, ln in seqs], np.int32)
        offs = np.zeros((len(seqs),), np.int32)
        np.cumsum(lens[:-1], out=offs[1:])
        # one flat triple list over every page of the batch
        triples = np.array(
            [(pg.shard * pps + pg.local_pid, pg.base_pos, k)
             for k, (pages, _) in enumerate(seqs) for pg in pages],
            np.int32).reshape(-1, 3)
        rows, base, owner = triples[:, 0], triples[:, 1], triples[:, 2]
        off = np.arange(ps, dtype=np.int32)
        rel = base[:, None] + off[None, :]             # [n_pages, ps]
        mask = rel < lens[owner][:, None]
        dest = (rows[:, None] * ps + off[None, :])[mask]
        pos = (rel + offs[owner][:, None])[mask]
        return dest, pos

    def write_payload_batch(
        self, seqs: Sequence[Tuple[Sequence[PageRef], np.ndarray]],
        keystreams: Optional[Sequence[Optional[np.ndarray]]] = None) -> None:
        """Anchor a whole batch of payloads with one flattened scatter per
        cache-sized tile — the host mirror of the fused kernel's
        single-pass payload placement. ``keystreams`` (aligned with
        ``seqs``, None entries = plaintext) fuses per-message hw-mode
        decryption into the same scatter: one XOR over the concatenated
        batch, no per-message pass."""
        if keystreams is None:
            keystreams = [None] * len(seqs)
        pairs = [(pages, p, ks) for (pages, p), ks in zip(seqs, keystreams)
                 if len(p) and pages]
        flat = self._flat.reshape(-1)
        tile_n = self.batch_tile([(pages, p) for pages, p, _ in pairs])
        for i in range(0, len(pairs), tile_n):
            tile = pairs[i : i + tile_n]
            dest, pos = self._batch_coords(
                [(pages, len(p)) for pages, p, _ in tile])
            cat = np.concatenate([p for _, p, _ in tile])
            vals = cat[pos]
            if any(ks is not None for _, _, ks in tile):
                kcat = np.concatenate(
                    [ks if ks is not None else np.zeros(len(p), np.int64)
                     for _, p, ks in tile])
                vals = np.bitwise_xor(vals, kcat[pos])
            flat[dest] = vals

    def read_payload_batch(
        self, seqs: Sequence[Tuple[Sequence[PageRef], int]],
        keystreams: Optional[Sequence[Optional[np.ndarray]]] = None,
    ) -> List[np.ndarray]:
        """One fused gather per cache-sized tile of anchored payloads;
        returns one array per (pages, length) request. ``keystreams``
        fuses per-message hw-mode TX encryption into the gather."""
        if keystreams is None:
            keystreams = [None] * len(seqs)
        flat = self._flat.reshape(-1)
        outs: List[np.ndarray] = []
        tile_n = self.batch_tile(seqs)
        for i in range(0, len(seqs), tile_n):
            tile = list(seqs[i : i + tile_n])
            kss = list(keystreams[i : i + tile_n])
            lens = [ln for _, ln in tile]
            out = np.zeros((sum(lens),), np.int64)
            if any(ln and pages for pages, ln in tile):
                dest, pos = self._batch_coords(tile)
                vals = flat[dest]
                if any(ks is not None for ks in kss):
                    kcat = np.concatenate(
                        [ks if ks is not None else np.zeros(ln, np.int64)
                         for (_, ln), ks in zip(tile, kss)])
                    vals = np.bitwise_xor(vals, kcat[pos])
                out[pos] = vals
            outs.extend(np.split(out, np.cumsum(lens)[:-1]))
        return outs

    # -- device data plane (fused kernel entry points) -----------------------

    def anchor_batch_device(self, stream: np.ndarray, meta_len: np.ndarray,
                            total_len: np.ndarray, tables: np.ndarray, *,
                            meta_max: int, impl: str,
                            keystream: Optional[np.ndarray] = None) -> None:
        """Run one batched ingress round through the fused selective-copy
        kernel. This host-resident pool pays the legacy price the paper's
        kernel-resident design exists to avoid: the WHOLE pool crosses the
        host/device boundary up (``astype(int32)``) and the touched rows
        sync back — one ``pool_syncs`` event per round. The resident
        :class:`~repro_torch.core.device_pool.DevicePool` overrides this with the
        zero-O(pool) path."""
        from repro_torch.kernels import ops

        pool = self.flat_with_scratch
        dev = self._upload(pool)
        self.xfer["h2d_tokens"] += pool.size + stream.size + tables.size \
            + (keystream.size if keystream is not None else 0)
        new_meta, new_pool = ops.selective_copy(
            self._upload(stream), self._upload(meta_len),
            self._upload(total_len), dev, self._upload(tables),
            meta_max=meta_max, impl=impl,
            keystream=None if keystream is None else self._upload(keystream))
        del new_meta  # host buffers keep the int64-exact metadata
        # sync back ONLY the rows this batch anchored: rows untouched by the
        # kernel keep their int64-exact host content
        touched = np.unique(tables[tables >= 0])
        host_pool = new_pool.cpu().numpy()
        self.xfer["d2h_tokens"] += host_pool.size
        pool[touched] = host_pool[touched]
        self.xfer["pool_syncs"] += 1
        self.xfer["device_rounds"] += 1
        self.xfer["anchor_rounds"] += 1


@dataclasses.dataclass
class CopyCounters:
    """Telemetry mirrored from the paper's Figure 9 categories."""
    meta_copied: int = 0        # Meta Sel-Copy
    full_copied: int = 0        # Std Copy (fallback/baseline path)
    anchored: int = 0           # payload tokens anchored (written once)
    zero_copied: int = 0        # Meta SKB-Trans: ownership-transferred tokens
    vpi_injected: int = 0
    allocs: int = 0             # Meta Alloc events
    # sw-kTLS-analogue tokens re-touched by SEPARATE crypto passes (§B.1
    # encrypt-and-copy / decrypt-and-copy); hw mode fuses the cipher into
    # the selective-copy pass and never increments this
    crypto_copied: int = 0
    # batched rounds bounced from the int32 device data plane back to the
    # int64-exact host scatter (out-of-range tokens detected pre-dispatch);
    # an event count, not a copy volume — excluded from snapshot()
    device_fallbacks: int = 0
    # cross-worker handoffs (multi-worker cluster). Grants are the zero-copy
    # path (an event count); cross_worker_copied is the token volume of the
    # one-copy fallback taken when the destination worker's pool sits above
    # its watermark. Both are counted SEPARATELY from the paper's Fig. 9
    # categories (excluded from snapshot()): a cluster run must remain
    # counter-identical to a single-stack run at any cross-worker fraction,
    # with the cross-worker machinery's own cost visible on the side.
    cross_worker_grants: int = 0
    cross_worker_copied: int = 0
    # L7 policy-offload verdicts (repro_torch.core.policy). Event counters like
    # cross_worker_grants: an offloaded run must stay Fig.-9-identical to
    # the same trace routed by Python callbacks, so all four stay out of
    # snapshot() — and, as plain dataclass fields, flow into
    # LibraCluster.counters_aggregate() with everything else.
    policy_hits: int = 0         # messages routed by the table (no Python)
    policy_punts: int = 0        # verdicts bounced to the callback slow path
    policy_drops: int = 0        # messages consumed + pages freed by DROP
    policy_rate_debits: int = 0  # RATE_LIMIT token-bucket debits
    policy_failovers: int = 0    # FORWARD verdicts re-routed by HealthTable

    def total_user_copies(self) -> int:
        return self.meta_copied + self.full_copied + self.crypto_copied

    def snapshot(self) -> Tuple[int, ...]:
        """Copy-volume identity tuple (host/device impls and batched/scalar
        schedules must agree on it; event counters stay out)."""
        return (self.meta_copied, self.full_copied, self.anchored,
                self.zero_copied, self.vpi_injected, self.allocs,
                self.crypto_copied)


class Connection:
    """One proxied connection pair (client<->proxy or proxy<->backend)."""

    _next_id = 0

    def __init__(self, parser: ParserPolicy, registry: VpiRegistry,
                 min_payload: int = 1, rx_compact: Optional[int] = None):
        Connection._next_id += 1
        self.conn_id = Connection._next_id
        # socket receive queue: amortized ring, zero-copy windows;
        # ``rx_compact`` tunes the proportional dead-prefix reclamation
        self.rx_ring = RxRing(min_compact=rx_compact if rx_compact else 64)
        self.rx_machine = RxStateMachine(parser, min_payload=min_payload)
        self.tx_machine = TxStateMachine(parser, registry.resolve,
                                         min_payload=min_payload,
                                         vpi_torn_down=registry.torn_down)
        self.tx_stream: List[np.ndarray] = []     # what actually went out
        self.anchored: Dict[int, Tuple[List[PageRef], int]] = {}  # vpi -> (pages, len)
        self.closed = False
        # §A.1 drain mode: tokens of an overflowed message still owed to the
        # native copy path (set by the ingress datapath on pool exhaustion)
        self.rx_drain_remaining = 0
        # kTLS-analogue session (repro_torch.core.crypto.TlsSession) — None for
        # plaintext connections; set by the socket facade when tls= is given
        self.crypto = None

    # -- socket plumbing -----------------------------------------------------
    def deliver(self, data: np.ndarray) -> None:
        """Network delivers bytes into the receive queue (NIC DMA analogue)."""
        self.rx_ring.push(np.asarray(data, np.int64))

    def rx_window(self, lookahead: int) -> np.ndarray:
        """Zero-copy parser window (valid until the next deliver/advance)."""
        return self.rx_ring.peek(lookahead)

    def rx_peek(self, n: int) -> np.ndarray:
        """Zero-copy view of up to ``n`` unread tokens."""
        return self.rx_ring.peek(n)

    def rx_advance(self, n: int) -> None:
        self.rx_ring.advance(n)

    def rx_available(self) -> int:
        return len(self.rx_ring)

    def rx_fingerprint(self) -> Tuple[int, int]:
        """Content-stable queue identity (for parse memoisation)."""
        return self.rx_ring.fingerprint()

    def tx_wire(self) -> np.ndarray:
        """Everything transmitted on this connection, concatenated — the
        byte stream a peer NIC would observe."""
        if not self.tx_stream:
            return np.zeros((0,), np.int64)
        return np.concatenate(self.tx_stream)
