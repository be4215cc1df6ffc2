"""Device KV pool + host allocator glue for the serving engine.

PyTorch twin of the JAX package's ``repro.serving.kv_cache``.
``PagedKVPool`` pairs ONE resident float32 pool tensor on a device with the
host-side ``AnchorPool`` allocator -- an external one (a ``LibraStack``'s,
``alloc=``) or one of explicit geometry (``n_shards``, ``pages_per_shard``,
``max_pages_per_seq``) -- and produces the int32 metadata arrays (block
tables, page positions, write coordinates) that the device mechanisms
consume — the control-plane half of the Libra datapath. The model writes
the pool in place (JAX donates it); a model whose pages hold another
number of tokens raises ``ValueError``, as do both geometries at once (the
JAX package asserts).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.anchor_pool import AnchorPool, PageRef
from repro_torch.core.vpi import VpiRegistry
from repro_torch.kernels.ops import checked_device


@dataclasses.dataclass
class SeqHandle:
    """Anchored-payload handle for one active sequence (VPI-backed)."""
    vpi: int
    pages: List[PageRef]
    seq_len: int          # tokens currently anchored
    header_len: int
    #: the decode metadata of ``pages`` (:class:`_PageRows`), built at the
    #: first step that needs it and again only when ``pages`` changes
    rows: Optional["_PageRows"] = dataclasses.field(
        default=None, repr=False, compare=False)


class _PageRows:
    """One handle's share of the per-step metadata, made from its page list
    once rather than walked again at every decode step: its block-table
    and page-position rows for each ``pps`` asked for, and its pages by
    base position for the write coordinates. Stands for ``pages`` while it
    is the same list with the same length and last page (the engine only
    ever appends to it, by :meth:`PagedKVPool.extend`)."""

    def __init__(self, pages: List[PageRef], n_shards: int, page_size: int):
        self.pages = pages
        self.n = len(pages)
        self.last = pages[-1] if pages else None
        self.page_size = page_size
        self.tables: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        slot_ctr = [0] * n_shards
        coords = []
        for pg in pages:
            coords.append((pg.base_pos, pg.shard, slot_ctr[pg.shard]))
            slot_ctr[pg.shard] += 1
        coords.sort()
        self.bases = [c[0] for c in coords]
        self.coords = [(c[1], c[2]) for c in coords]
        self.arrays = (np.asarray(self.bases, np.int64),
                       np.asarray([c[1] for c in coords], np.int32),
                       np.asarray([c[2] for c in coords], np.int32))
        # pages that overlap make a write position ambiguous:
        # ``AnchorPool.write_coords`` judges those lists itself
        self.disjoint = all(b - a >= page_size
                            for a, b in zip(self.bases, self.bases[1:]))

    def fresh(self, pages: List[PageRef]) -> bool:
        return (pages is self.pages and len(pages) == self.n
                and (pages[-1] if pages else None) is self.last)

    def tokens(self, seq_len: int):
        """``AnchorPool.token_coords``' row for positions ``[0, seq_len)``:
        each one's (shard, slot, offset, valid); None for no pages, or for
        overlapping ones (there the last page in list order wins, which
        that walk decides)."""
        if not self.disjoint or not self.bases:
            return None
        bases, shard, slot = self.arrays
        t = np.arange(seq_len)
        j = np.maximum(np.searchsorted(bases, t, side="right") - 1, 0)
        off = t - bases[j]
        valid = (off >= 0) & (off < self.page_size)
        return tuple(np.where(valid, a, 0).astype(np.int32)
                     for a in (shard[j], slot[j], off)) + (valid,)

    def write(self, pos: int) -> Optional[Tuple[int, int]]:
        """The (shard, slot) of the one page that holds ``pos``, or None
        where no page or (overlapping pages) more than one might."""
        if not self.disjoint:
            return None
        j = bisect.bisect_right(self.bases, pos) - 1
        if j < 0 or pos >= self.bases[j] + self.page_size:
            return None
        return self.coords[j]


class PagedKVPool:
    def __init__(self, model, n_shards: Optional[int] = None,
                 pages_per_shard: Optional[int] = None,
                 page_size: int = 16, registry: Optional[VpiRegistry] = None,
                 max_pages_per_seq: int = 0,
                 alloc: Optional[AnchorPool] = None, device="cuda"):
        self.model = model
        # either an external allocator (a LibraStack's -- its geometry
        # defines the device pool shape) or explicit geometry, never both
        if alloc is not None:
            if n_shards is not None or pages_per_shard is not None:
                raise ValueError("pass geometry via alloc= OR "
                                 "n_shards/pages_per_shard, not both")
            if alloc.page_size != page_size:
                raise ValueError(f"the allocator's pages hold "
                                 f"{alloc.page_size} tokens, not {page_size}")
        else:
            alloc = AnchorPool(n_shards, pages_per_shard, page_size,
                               max_pages_per_seq=max_pages_per_seq)
        if model.page_size != alloc.page_size:
            raise ValueError(f"the model's pool pages hold {model.page_size} "
                             f"tokens, the allocator's {alloc.page_size}")
        self.alloc = alloc
        self.page_size = alloc.page_size
        # ``is None``: an empty registry is falsy, and the JAX package's
        # ``registry or VpiRegistry()`` swaps a stack's fresh one for its own
        self.registry = registry if registry is not None else VpiRegistry()
        self.device = checked_device(device)
        self.pool = torch.zeros(model.kv_pool_shape(alloc.total_pages),
                                dtype=torch.float32, device=self.device)
        self.n_shards = alloc.n_shards

    # -- sequence lifecycle -------------------------------------------------
    def anchor_sequence(self, prompt_len: int, header_len: int,
                        reserve: int = 0) -> SeqHandle:
        pages = self.alloc.alloc_sequence(prompt_len + reserve)
        vpi = self.registry.register(
            "kv-pool", [(p.shard, p.local_pid, p.base_pos) for p in pages],
            prompt_len, meta={"header_len": header_len})
        return SeqHandle(vpi, pages, prompt_len, header_len)

    def extend(self, h: SeqHandle, new_len: int) -> None:
        """Grow the anchored region (decode appends)."""
        have = len(h.pages) * self.page_size
        while have < new_len:
            shard = (len(h.pages)) % self.n_shards
            h.pages.append(self.alloc.alloc_page(
                len(h.pages) * self.page_size, shard))
            have += self.page_size
        h.seq_len = new_len

    def release(self, h: SeqHandle) -> None:
        if self.registry.release(h.vpi):
            self.alloc.free_pages_list(h.pages)

    def share(self, h: SeqHandle) -> SeqHandle:
        """Prefix sharing / zero-copy forwarding: bump refcounts, same pages."""
        self.registry.retain(h.vpi)
        self.alloc.retain(h.pages)
        return SeqHandle(h.vpi, list(h.pages), h.seq_len, h.header_len)

    # -- device metadata ------------------------------------------------------
    # A decode step needs every active handle's rows; each handle's are
    # built once (``SeqHandle.rows``) and the step stacks them, so the
    # host's work a step no longer grows with the pages the batch holds.
    # The arrays are those of ``AnchorPool.tables_for`` / ``write_coords``.
    def _rows(self, h: SeqHandle) -> _PageRows:
        if h.rows is None or not h.rows.fresh(h.pages):
            h.rows = _PageRows(h.pages, self.n_shards, self.page_size)
        return h.rows

    def batch_tables(self, handles: Sequence[SeqHandle],
                     pps: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        if pps is None:
            pps = self.alloc.pages_per_shard
        if not handles:
            return self.alloc.tables_for([], pps)
        out = []
        for h in handles:
            rows = self._rows(h)
            if pps not in rows.tables:
                t, p = self.alloc.tables_for([h.pages], pps)
                rows.tables[pps] = (t[0], p[0])
            out.append(rows.tables[pps])
        return (np.stack([t for t, _ in out]), np.stack([p for _, p in out]))

    def write_coords(self, handles: Sequence[SeqHandle],
                     positions: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        wsh = np.zeros((len(handles),), np.int32)
        wsl = np.zeros((len(handles),), np.int32)
        for i, (h, pos) in enumerate(zip(handles, positions)):
            hit = self._rows(h).write(pos)
            if hit is None:   # no page, or overlapping ones: judged there
                (a,), (b,) = AnchorPool.write_coords(
                    [h.pages], [pos], self.n_shards, self.page_size)
                hit = (a, b)
            wsh[i], wsl[i] = hit
        return wsh, wsl

    def token_coords(self, handles: Sequence[SeqHandle], seq_len: int):
        rows = [self._rows(h).tokens(seq_len) for h in handles]
        if not rows or any(r is None for r in rows):
            return self.alloc.token_coords([h.pages for h in handles], seq_len)
        return tuple(np.stack([r[k] for r in rows]) for k in range(4))
