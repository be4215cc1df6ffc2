"""Serving engine of the port: ``LibraEngine``, continuous-batching LLM
serving over the Libra datapath.

PyTorch twin of the JAX package's ``repro.serving.engine.LibraEngine``:
selective copy — paged anchored KV updated in place, the parser policy
splits header/payload, only token ids + O(pages) int32 metadata cross the
host boundary, VPI handles support zero-copy forwarding. ``EngineStats``
counts exactly what the JAX engine counts.

One device and no mesh: every page lives on ``device`` (``n_shards`` = 1,
in place of ``plan_decode_sharding``), and the model updates the pool in
place (in place of donation). ``device`` is ``"cuda"`` by default and
raises without a GPU; tests pass ``"cpu"``. The baseline engines
(``StandardEngine``, ``CopierEngine``, ``StaticEngine``) are not ported yet
(``ROADMAP.md``, queue 1, item 8).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.anchor_pool import PoolExhausted
from repro_torch.core.parser import TokenStreamParser
from repro_torch.core.stack import LibraStack
from repro_torch.kernels.ops import checked_device
from repro_torch.serving.kv_cache import PagedKVPool, SeqHandle


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # full token stream (header + payload)
    header_len: int
    max_new_tokens: int
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None
    output: List[int] = dataclasses.field(default_factory=list)
    handle: Optional[SeqHandle] = None
    slot: int = -1

    @property
    def done(self) -> bool:
        return len(self.output) >= self.max_new_tokens


@dataclasses.dataclass
class EngineStats:
    # host<->device boundary traffic (the kernel/user boundary analogue)
    h2d_bytes: int = 0           # tokens + metadata uploaded
    d2h_bytes: int = 0           # tokens / logits downloaded
    d2h_calls: int = 0           # per-connection transfer count
    # device-side payload movement
    payload_copy_bytes: int = 0  # full-cache copies (Std/Copier copy tax)
    anchored_bytes: int = 0      # payload written once into the pool
    zero_copy_bytes: int = 0     # ownership transfers (VPI forwarding)
    steps: int = 0
    prefills: int = 0
    completed: int = 0
    alloc_events: int = 0


def _pad_to(x: np.ndarray, n: int, fill=0) -> np.ndarray:
    if len(x) >= n:
        return x[:n]
    return np.concatenate([x, np.full(n - len(x), fill, x.dtype)])


class _EngineBase:
    name = "base"

    def __init__(self, model, params, *, max_batch: int = 8,
                 max_len: int = 512, parser: Optional[TokenStreamParser] = None):
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.parser = parser or TokenStreamParser(header_len=8)
        self.stats = EngineStats()
        self.waiting: List[Request] = []
        self.active: List[Request] = []
        self.completed: List[Request] = []
        self._rid = 0

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> Request:
        self._rid += 1
        r = Request(self._rid, np.asarray(prompt, np.int32),
                    self.parser.parse(prompt).meta_len, max_new_tokens,
                    submitted_at=time.perf_counter())
        self.waiting.append(r)
        return r

    def run(self, max_steps: int = 10 ** 6) -> List[Request]:
        steps = 0
        while (self.waiting or self.active) and steps < max_steps:
            self.step()
            steps += 1
        return self.completed

    # latency metrics -------------------------------------------------------
    def p99_latency(self) -> float:
        lats = sorted((r.done_at - r.submitted_at) for r in self.completed
                      if r.done_at)
        if not lats:
            return 0.0
        return lats[min(len(lats) - 1, int(0.99 * len(lats)))]

    def throughput_tokens(self) -> int:
        return sum(len(r.output) for r in self.completed)


class LibraEngine(_EngineBase):
    name = "libra"

    def __init__(self, model, params, *, max_batch: int = 8, max_len: int = 512,
                 page_size: int = 16, parser=None, device="cuda"):
        super().__init__(model, params, max_batch=max_batch, max_len=max_len,
                         parser=parser)
        self.device = checked_device(device)
        self.page_size = page_size
        self.pps = max_len // page_size + 2
        # one LibraStack per engine "kernel": it owns the page allocator, the
        # VPI registry, the tick clock, and the copy counters. One device
        # owns every page, so the stack has one shard.
        self.stack = LibraStack(n_shards=1,
                                pages_per_shard=max_batch * self.pps + 4,
                                page_size=page_size, device=self.device)
        self.pool = PagedKVPool(model, self.stack.alloc, self.stack.registry,
                                device=self.device)
        # parking page for inactive slots (keeps decode NaN-free)
        self._parking = self.pool.alloc.alloc_page(0, 0)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- ingress (prefill anchors the payload) -------------------------------
    def _prefill_group(self, group: List[Request]) -> None:
        s = max(len(r.prompt) for r in group)
        s = max(self.page_size, -(-s // self.page_size) * self.page_size)
        handles = [r.handle for r in group]  # allocated at admission
        tokens = np.stack([_pad_to(r.prompt, s) for r in group])
        seq_lens = np.array([len(r.prompt) for r in group], np.int32)
        tables, _ = self.pool.batch_tables(handles, self.pps)
        tsh, tsl, toff, tval = self.pool.token_coords(handles, s)

        first = self.model.prefill(
            self.params, self._dev(tokens), self._dev(seq_lens),
            self.pool.pool, self._dev(tables), self._dev(tsh),
            self._dev(tsl), self._dev(toff), self._dev(tval))
        first = first.cpu().numpy()
        now = time.perf_counter()
        for i, r in enumerate(group):
            r.output.append(int(first[i]))
            r.first_token_at = now
        # stats: selective copy — tokens up, ONLY sampled ids down
        self.stats.h2d_bytes += tokens.nbytes + tables.nbytes + tsh.nbytes * 3
        self.stats.d2h_bytes += first.nbytes
        self.stats.d2h_calls += 1
        # in Python ints: the JAX engine's int32 product wraps past 2 GiB
        self.stats.anchored_bytes += (int(seq_lens.sum())
                                      * self._kv_bytes_per_token())
        self.stats.prefills += 1
        self.stats.alloc_events += len(group)

    def _kv_bytes_per_token(self) -> int:
        c = self.cfg
        return c.num_layers * 2 * c.num_kv_heads * c.head_dim * 4

    def step(self) -> None:
        # each engine step advances the stack clock: deferred teardowns from
        # closed connections expire on the engine's cadence (§A.4)
        self.stack.tick()
        # admit
        free = self.max_batch - len(self.active)
        group = []
        while self.waiting and free > 0:
            r = self.waiting[0]
            try:
                # reserve prompt + decode room at admission so an admitted
                # request can always finish (vLLM-style admission soundness)
                r.handle = self.pool.anchor_sequence(
                    len(r.prompt), r.header_len, reserve=r.max_new_tokens)
            except PoolExhausted:
                break
            c = self.stack.counters
            c.anchored += len(r.prompt) - r.header_len
            c.meta_copied += r.header_len
            c.vpi_injected += 1
            c.allocs += 1
            self.waiting.pop(0)
            group.append(r)
            free -= 1
        if group:
            self._prefill_group(group)
            now = time.perf_counter()
            for r in group:  # gen=1 requests complete at prefill
                if r.done:
                    r.done_at = now
                    self.pool.release(r.handle)
                    self.completed.append(r)
                    self.stats.completed += 1
                else:
                    self.active.append(r)
        if not self.active:
            return

        # decode one token for every active request
        b = self.max_batch
        handles = []
        seq_lens = np.zeros(b, np.int32)
        tokens = np.zeros(b, np.int32)
        for i, r in enumerate(self.active):
            r.slot = i
            pos = len(r.prompt) + len(r.output) - 1
            self.pool.extend(r.handle, pos + 1)
            handles.append(r.handle)
            seq_lens[i] = pos
            tokens[i] = r.output[-1]
        # inactive slots park on a scratch page
        parking = SeqHandle(0, [self._parking], 0, 0)
        while len(handles) < b:
            handles.append(parking)
        tables, page_pos = self.pool.batch_tables(handles, self.pps)
        wsh, wsl = self.pool.write_coords(handles, seq_lens.tolist())

        next_tokens = self.model.decode_step(
            self.params, self._dev(tokens), self._dev(seq_lens),
            self.pool.pool, self._dev(tables), self._dev(page_pos),
            self._dev(wsh), self._dev(wsl))
        next_tokens = next_tokens.cpu().numpy()

        self.stats.h2d_bytes += (tokens.nbytes + seq_lens.nbytes + tables.nbytes
                                 + page_pos.nbytes + wsh.nbytes + wsl.nbytes)
        self.stats.d2h_bytes += next_tokens.nbytes
        self.stats.d2h_calls += 1
        self.stats.anchored_bytes += len(self.active) * self._kv_bytes_per_token()
        self.stats.steps += 1

        now = time.perf_counter()
        still = []
        for r in self.active:
            r.output.append(int(next_tokens[r.slot]))
            if r.done:
                r.done_at = now
                self.pool.release(r.handle)
                self.completed.append(r)
                self.stats.completed += 1
            else:
                still.append(r)
        self.active = still

    # -- egress: zero-copy forwarding (VPI handoff) ---------------------------
    def forward_handle(self, r: Request) -> SeqHandle:
        """Proxy forwarding: hand the anchored context to another consumer
        without moving payload bytes (refcounted ownership share)."""
        h = self.pool.share(r.handle)
        self.stats.zero_copy_bytes += h.seq_len * self._kv_bytes_per_token()
        self.stack.counters.zero_copied += h.seq_len
        return h

    def release_handle(self, h: SeqHandle) -> None:
        """Drop a forwarded handle (the backend finished with the shared
        context). Facade call so call-sites never touch the pool."""
        self.pool.release(h)
