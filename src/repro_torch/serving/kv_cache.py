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

import dataclasses
from typing import List, Optional, Sequence, Tuple

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
    def batch_tables(self, handles: Sequence[SeqHandle],
                     pps: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        return self.alloc.tables_for([h.pages for h in handles], pps)

    def write_coords(self, handles: Sequence[SeqHandle],
                     positions: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        return AnchorPool.write_coords([h.pages for h in handles], positions,
                                       self.n_shards, self.page_size)

    def token_coords(self, handles: Sequence[SeqHandle], seq_len: int):
        return self.alloc.token_coords([h.pages for h in handles], seq_len)
