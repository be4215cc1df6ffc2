"""Anchor pool — the kernel-side socket buffer of the TPU adaptation.

Host-side allocator + accounting for the device-resident paged payload pool
(``[P, page, 2, Hkv, hd]`` per layer on device). Implements the paper's
appendix substrate:

* §A.1 receive-window management → watermarks + per-sequence anchoring cap
  (``max_pages_per_seq``); overflow falls back to the copy path instead of
  OOM-ing the pool.
* §A.2 deadlock-free transfer → two-phase page handoff through a staging
  list (extract from RX owner, then commit to TX owner; never both "locked").
* §A.3 send-side memory accounting → logical byte budget that is raised by
  exactly the staged size during a handoff and restored after.
* §A.4 refcount + deferred teardown → per-page refcounts (prefix sharing)
  and grace-period frees, driven by VpiRegistry.
* §A.5 granularity matching → ``page_size`` is the MAX_SKB_FRAGS analogue;
  ring-buffer tables support sliding-window (bounded) anchoring.

The allocator is pure host metadata: device code receives int32 arrays
(block tables, page base positions, write coordinates) — the Libra
mechanism/policy split.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class PoolExhausted(Exception):
    pass


@dataclasses.dataclass
class PageRef:
    shard: int
    local_pid: int
    base_pos: int


class AnchorPool:
    """Allocator for one device pool, striped over ``n_shards`` combine
    shards within one data row (see attention.plan_decode_sharding)."""

    def __init__(
        self,
        n_shards: int,
        pages_per_shard: int,
        page_size: int,
        max_pages_per_seq: int = 0,        # 0 = unlimited (§A.1 cap)
        high_watermark: float = 0.9,
    ):
        self.n_shards = n_shards
        self.pages_per_shard = pages_per_shard
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.high_watermark = high_watermark
        self._free: List[List[int]] = [
            list(range(pages_per_shard - 1, -1, -1)) for _ in range(n_shards)
        ]
        self._refcount: Dict[Tuple[int, int], int] = {}
        # §A.3 logical accounting
        self.bytes_per_page = page_size  # logical tokens; scaled by caller
        self.accounted_pages = 0
        self.budget_pages = n_shards * pages_per_shard
        self._budget_raise = 0
        # deferred frees (§A.4)
        self._deferred: List[Tuple[int, List[PageRef]]] = []
        # pages currently pinned by outbound cross-worker grants (gauge)
        self.granted_out_pages = 0
        self.stats = {"allocs": 0, "frees": 0, "fallbacks": 0,
                      "deferred_frees": 0, "exports": 0, "export_releases": 0}

    # -- capacity ----------------------------------------------------------
    @property
    def total_pages(self) -> int:
        return self.n_shards * self.pages_per_shard

    @property
    def scratch_page(self) -> int:
        """Flat index of the scratch row reserved at allocation time — the
        dummy DMA target the fused selective-copy kernel routes invalid
        table entries to. Lives one row past the allocatable pages (the
        freelists never hand it out), so the device pool needs no per-call
        extension/copy."""
        return self.total_pages

    def flat_pid(self, pg: "PageRef") -> int:
        """Flat [0, total_pages) row index of a page (device table entry)."""
        return pg.shard * self.pages_per_shard + pg.local_pid

    @property
    def free_pages(self) -> int:
        return sum(len(f) for f in self._free)

    @property
    def used_fraction(self) -> float:
        return 1.0 - self.free_pages / max(self.total_pages, 1)

    def above_watermark(self) -> bool:
        return self.used_fraction >= self.high_watermark

    def can_admit(self, n_pages: int) -> bool:
        if self.max_pages_per_seq and n_pages > self.max_pages_per_seq:
            return False
        if self.accounted_pages + n_pages > self.budget_pages + self._budget_raise:
            return False
        return self.free_pages >= n_pages

    # -- allocation ----------------------------------------------------------
    def _pick_shard(self) -> int:
        # biased to the fullest freelist to keep shards balanced
        return max(range(self.n_shards), key=lambda s: len(self._free[s]))

    def _take_page(self, shard: int, base_pos: int) -> PageRef:
        """Unchecked single-page pop — the ONE copy of the placement
        policy (preferred shard, else fullest freelist) shared by
        alloc_page and alloc_batch. The caller has already verified a
        free page exists somewhere."""
        if not self._free[shard]:
            shard = max(range(self.n_shards),
                        key=lambda s: len(self._free[s]))
        pid = self._free[shard].pop()
        self._refcount[(shard, pid)] = 1
        return PageRef(shard, pid, base_pos)

    def alloc_page(self, base_pos: int, shard: Optional[int] = None) -> PageRef:
        if shard is None:
            shard = self._pick_shard()
        if self.free_pages == 0:
            raise PoolExhausted()
        pg = self._take_page(shard, base_pos)
        self.accounted_pages += 1
        self.stats["allocs"] += 1
        return pg

    def alloc_sequence(self, seq_len: int, striped: bool = True) -> List[PageRef]:
        """Allocate pages for a sequence of ``seq_len`` tokens, striping
        page p onto shard p % n_shards (flash-decode locality layout).
        A zero-length sequence owns no pages (nothing to anchor — it must
        not consume a page of pool budget)."""
        n = -(-max(seq_len, 0) // self.page_size)
        if not self.can_admit(n):
            self.stats["fallbacks"] += 1
            raise PoolExhausted()
        pages = []
        try:
            for p in range(n):
                shard = (p % self.n_shards) if striped else None
                if striped and not self._free[shard]:
                    shard = None  # fall back to any shard
                pages.append(self.alloc_page(p * self.page_size, shard))
        except PoolExhausted:
            self.free_pages_list(pages)
            self.stats["fallbacks"] += 1
            raise
        return pages

    def alloc_batch(self, sizes: Sequence[int]) -> List[Optional[List[PageRef]]]:
        """Bulk page allocation for one batched round: allocate pages for
        every sequence of ``sizes`` in a single pass over the freelists
        (no per-item call/exception machinery on the hot path).

        Admission is greedy in order — an item that cannot be admitted
        (per-sequence §A.1 cap, §A.3 budget, or pool exhaustion) yields
        ``None`` in its slot (that message falls back to the scalar path)
        without disturbing the items around it. Placement is identical to
        per-item :meth:`alloc_sequence` calls in the same order, so batched
        and scalar schedules agree on the pool layout byte-for-byte."""
        out: List[Optional[List[PageRef]]] = []
        allocs = 0
        for seq_len in sizes:
            n = -(-max(seq_len, 0) // self.page_size)
            if not self.can_admit(n):
                self.stats["fallbacks"] += 1
                out.append(None)
                continue
            pages = [self._take_page(p % self.n_shards, p * self.page_size)
                     for p in range(n)]
            self.accounted_pages += n
            allocs += n
            out.append(pages)
        self.stats["allocs"] += allocs
        return out

    def free_batch(self, seqs: Sequence[Optional[Sequence[PageRef]]]) -> int:
        """Bulk refcount-release for a round's page lists (``None`` entries
        are skipped). Returns the number of page references released."""
        freed = 0
        for pages in seqs:
            if not pages:
                continue
            self.free_pages_list(pages)
            freed += len(pages)
        return freed

    # -- refcounts / free -----------------------------------------------------
    def retain(self, pages: Sequence[PageRef]) -> None:
        for pg in pages:
            self._refcount[(pg.shard, pg.local_pid)] += 1
            self.accounted_pages += 1

    def free_pages_list(self, pages: Sequence[PageRef]) -> None:
        for pg in pages:
            key = (pg.shard, pg.local_pid)
            rc = self._refcount.get(key, 0)
            if rc <= 1:
                self._refcount.pop(key, None)
                self._free[pg.shard].append(pg.local_pid)
                self.stats["frees"] += 1
            else:
                self._refcount[key] = rc - 1
            self.accounted_pages -= 1

    def defer_free(self, pages: Sequence[PageRef], deadline_tick: int) -> None:
        self._deferred.append((deadline_tick, list(pages)))

    def expire_deferred(self, now_tick: int) -> int:
        kept, n = [], 0
        for deadline, pages in self._deferred:
            if now_tick >= deadline:
                self.free_pages_list(pages)
                n += len(pages)
                self.stats["deferred_frees"] += len(pages)
            else:
                kept.append((deadline, pages))
        self._deferred = kept
        return n

    # -- cross-worker grant pinning (multi-worker §A.4 extension) --------------
    def export_grant(self, pages: Sequence[PageRef]) -> None:
        """Pin ``pages`` for a zero-copy grant handed to another worker:
        each page gains a refcount (exactly like §A.4 prefix sharing), so
        the owner socket's teardown grace can expire — dropping the
        *original* reference — without the granted payload ever hitting
        the freelist. The pin is accounted (§A.3) against THIS pool: the
        memory stays resident here until the grantee releases it."""
        self.retain(pages)
        self.granted_out_pages += len(pages)
        self.stats["exports"] += 1

    def release_export(self, pages: Sequence[PageRef]) -> None:
        """Drop a grant pin (grantee's egress completed, or the grant was
        abandoned). The pages return to the freelist only when every other
        reference — including the owner's own — is gone."""
        self.free_pages_list(pages)
        self.granted_out_pages -= len(pages)
        self.stats["export_releases"] += 1

    # -- §A.2/§A.3 two-phase ownership transfer --------------------------------
    def stage_transfer(self, pages: Sequence[PageRef]) -> List[PageRef]:
        """Phase 1: extract from the RX side into a staging list. The budget
        is raised by exactly the staged size (§A.3): no real memory is
        allocated, but accounting must not underflow on commit."""
        staged = list(pages)
        self._budget_raise += len(staged)
        return staged

    def _unstage(self, staged: Sequence[PageRef]) -> List[PageRef]:
        """Restore the §A.3 budget raise for a staging list (the one copy
        of the accounting shared by commit and abort)."""
        self._budget_raise -= len(staged)
        assert self._budget_raise >= 0
        return list(staged)

    def commit_transfer(self, staged: Sequence[PageRef]) -> List[PageRef]:
        """Phase 2: ownership now belongs to the TX side; restore budget."""
        return self._unstage(staged)

    def abort_transfer(self, staged: Sequence[PageRef]) -> List[PageRef]:
        """Failed handoff: the egress path staged pages but never committed
        them (e.g. the payload compose raised). Ownership stays with the RX
        side; the §A.3 budget raise must still be restored, or it stays
        elevated forever and the accounting cap silently widens."""
        return self._unstage(staged)

    # -- device metadata ---------------------------------------------------------
    def tables_for(
        self,
        seqs: Sequence[Sequence[PageRef]],
        pps: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Build (block_tables, page_pos) [B, n_shards, pps] device metadata
        for a batch of page lists. Slots are filled per shard in allocation
        order; unused entries are -1."""
        b = len(seqs)
        if pps is None:
            pps = self.pages_per_shard
        tables = -np.ones((b, self.n_shards, pps), np.int32)
        page_pos = -np.ones((b, self.n_shards, pps), np.int32)
        for i, pages in enumerate(seqs):
            slot_ctr = [0] * self.n_shards
            for pg in pages:
                s = slot_ctr[pg.shard]
                if s >= pps:
                    raise PoolExhausted(f"pages-per-shard overflow: {s} >= {pps}")
                tables[i, pg.shard, s] = pg.local_pid
                page_pos[i, pg.shard, s] = pg.base_pos
                slot_ctr[pg.shard] += 1
        return tables, page_pos

    @staticmethod
    def write_coords(
        seqs: Sequence[Sequence[PageRef]],
        positions: Sequence[int],
        n_shards: int,
        page_size: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-request (write_shard, write_slot) for appending at
        ``positions[i]`` — exactly ONE page of the sequence must cover that
        position. Overlapping pages are a corrupted table (two pages would
        both claim the write) and assert instead of silently resolving
        last-match-wins."""
        b = len(seqs)
        wsh = np.zeros((b,), np.int32)
        wsl = np.zeros((b,), np.int32)
        for i, (pages, pos) in enumerate(zip(seqs, positions)):
            slot_ctr = [0] * n_shards
            matches = 0
            for pg in pages:
                s = slot_ctr[pg.shard]
                slot_ctr[pg.shard] += 1
                if pg.base_pos <= pos < pg.base_pos + page_size:
                    wsh[i], wsl[i] = pg.shard, s
                    matches += 1
            assert matches == 1, \
                (i, pos, matches, [p.base_pos for p in pages])
        return wsh, wsl

    def token_coords(
        self, seqs: Sequence[Sequence[PageRef]], seq_len: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Prefill metadata: per-token (shard, slot, offset, valid) arrays
        of shape [B, seq_len]."""
        b = len(seqs)
        tsh = np.zeros((b, seq_len), np.int32)
        tsl = np.zeros((b, seq_len), np.int32)
        toff = np.zeros((b, seq_len), np.int32)
        tval = np.zeros((b, seq_len), bool)
        for i, pages in enumerate(seqs):
            slot_ctr = [0] * self.n_shards
            for pg in pages:
                s = slot_ctr[pg.shard]
                slot_ctr[pg.shard] += 1
                lo = pg.base_pos
                hi = min(lo + self.page_size, seq_len)
                if lo >= seq_len:
                    continue
                tsh[i, lo:hi] = pg.shard
                tsl[i, lo:hi] = s
                toff[i, lo:hi] = np.arange(hi - lo)
                tval[i, lo:hi] = True
        return tsh, tsl, toff, tval
