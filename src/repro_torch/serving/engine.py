"""Serving engines of the port -- the paper's four stacks, as
continuous-batching LLM servers, PyTorch twins of the JAX package's
``repro.serving.engine``:

* ``LibraEngine``    -- selective copy: paged anchored KV updated in place,
                        the parser policy splits header/payload, only token
                        ids + O(pages) int32 metadata cross the host
                        boundary, VPI handles support zero-copy forwarding.
                        A ``stack`` (and its ``kv_pool``) may be shared
                        between engines. Under the ``hybrid`` family it
                        also keeps the Mamba state (``ssm_state``), a row
                        a batch slot, which decode steps advance in place
                        and prefill never writes.
* ``StandardEngine`` -- standard stack: contiguous KV copied whole every
                        step (``decode_step_dense`` undonated), full logits
                        downloaded *per connection*, one transfer and one
                        sync each.
* ``CopierEngine``   -- Copier: the same data volume, the per-connection
                        downloads batched into one copy a step.
* ``StaticEngine``   -- F-Stack/DPDK analogue: one preallocated dense cache
                        written in place; a fixed memory budget caps the
                        batch.

``EngineStats`` counts exactly what the JAX engines count. One device and
no mesh: every page lives on ``device`` (in place of
``plan_decode_sharding``), and the model updates the pool in place (in
place of donation). ``device`` is ``"cuda"`` by default and raises without
a GPU; tests pass ``"cpu"``. The baselines write a prefilled request's KV
into its cache slot in place, where the JAX engines make a new cache with
``.at[].set`` (the stats count neither).

While tracing is on (``common/tracing.py``), ``LibraEngine.step`` records
a span of each step and of its phases: ``engine.admit``, ``engine.prefill``
(counters ``tokens``, the prompts' real tokens, and ``slots``, the group
times its padded width) and ``engine.decode``, each of the last two split
into ``engine.prepare`` (host arrays), ``engine.upload`` (their copies to
the device), the model's call, ``engine.wait`` (the sampled ids' download)
and ``engine.finish`` (tokens, completions, releases).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.common.tracing import span
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
                 max_len: int = 512, parser: Optional[TokenStreamParser] = None,
                 device="cuda"):
        self.device = checked_device(device)
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

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

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
                 page_size: int = 16, parser=None, pool_pages: int = 0,
                 stack: Optional[LibraStack] = None,
                 kv_pool: Optional[PagedKVPool] = None, device="cuda"):
        super().__init__(model, params, max_batch=max_batch, max_len=max_len,
                         parser=parser, device=device)
        self.page_size = page_size
        self.pps = max_len // page_size + 2
        # one LibraStack per engine "kernel": it owns the page allocator, the
        # VPI registry, the tick clock, and the copy counters. A shared
        # ``stack`` pools that host state across engines; zero-copy
        # CROSS-ENGINE handoff additionally needs the device KV itself
        # shared -- pass the first engine's ``kv_pool`` to the second
        # (handles forwarded into an engine with its own pool would index a
        # different, zero-filled device tensor).
        if stack is None:
            stack = LibraStack(n_shards=1,
                               pages_per_shard=(pool_pages
                                                or max_batch * self.pps + 4),
                               page_size=page_size, device=self.device)
        elif pool_pages:
            raise ValueError("pool_pages conflicts with an external stack: "
                             "the stack's allocator defines the geometry")
        if stack.alloc.page_size != page_size:
            raise ValueError(f"the stack's pages hold {stack.alloc.page_size} "
                             f"tokens, the engine's {page_size}")
        self.stack = stack
        if kv_pool is not None:
            if kv_pool.alloc is not stack.alloc:
                raise ValueError("a shared kv_pool must be backed by the "
                                 "shared stack's allocator")
            self.pool = kv_pool
        else:
            self.pool = PagedKVPool(model, page_size=page_size,
                                    alloc=stack.alloc, registry=stack.registry,
                                    device=self.device)
        # parking page for inactive slots (keeps decode NaN-free)
        self._parking = self.pool.alloc.alloc_page(0, 0)
        # the hybrid family's Mamba state, a row a batch slot: made zero
        # once and only ever advanced by decode steps (prefill writes none),
        # so a request decodes from whatever its row last held, as in the
        # JAX engine (a fault of the reference, carried)
        self.ssm_state = None
        if self.cfg.family == "hybrid":
            self.ssm_state = {
                k: torch.zeros(shape, dtype=torch.float32, device=self.device)
                for k, shape in model.ssm_state_shapes(max_batch).items()}

    # -- ingress (prefill anchors the payload) -------------------------------
    def _prefill_width(self, group: List[Request]) -> int:
        """The group's prompts are padded to the longest, in whole pages."""
        s = max(len(r.prompt) for r in group)
        return max(self.page_size, -(-s // self.page_size) * self.page_size)

    def _prefill_group(self, group: List[Request]) -> None:
        """Prefill the admitted ``group`` together; a request whose first
        token is its last completes here."""
        with span("engine.prepare"):
            s = self._prefill_width(group)
            handles = [r.handle for r in group]  # allocated at admission
            tokens = np.stack([_pad_to(r.prompt, s) for r in group])
            seq_lens = np.array([len(r.prompt) for r in group], np.int32)
            tables, _ = self.pool.batch_tables(handles, self.pps)
            tsh, tsl, toff, tval = self.pool.token_coords(handles, s)
        with span("engine.upload"):
            dev = [self._dev(a) for a in (tokens, seq_lens, tables, tsh, tsl,
                                          toff, tval)]
        first = self.model.prefill(self.params, *dev[:2], self.pool.pool,
                                   *dev[2:])
        with span("engine.wait"):
            first = first.cpu().numpy()
        with span("engine.finish"):
            now = time.perf_counter()
            for i, r in enumerate(group):
                r.output.append(int(first[i]))
                r.first_token_at = now
            # stats: selective copy — tokens up, ONLY sampled ids down
            self.stats.h2d_bytes += (tokens.nbytes + tables.nbytes
                                     + tsh.nbytes * 3)
            self.stats.d2h_bytes += first.nbytes
            self.stats.d2h_calls += 1
            # in Python ints: the JAX engine's int32 product wraps past 2 GiB
            self.stats.anchored_bytes += (int(seq_lens.sum())
                                          * self._kv_bytes_per_token())
            self.stats.prefills += 1
            self.stats.alloc_events += len(group)
            now = time.perf_counter()
            for r in group:  # gen=1 requests complete at prefill
                if r.done:
                    r.done_at = now
                    self.pool.release(r.handle)
                    self.completed.append(r)
                    self.stats.completed += 1
                else:
                    self.active.append(r)

    def _kv_bytes_per_token(self) -> int:
        c = self.cfg
        return c.num_layers * 2 * c.num_kv_heads * c.head_dim * 4

    def step(self) -> None:
        with span("engine.step"):
            # each engine step advances the stack clock: deferred teardowns
            # from closed connections expire on the engine's cadence (§A.4)
            self.stack.tick()
            with span("engine.admit"):
                group = self._admit()
            if group:
                with span("engine.prefill",
                          tokens=sum(len(r.prompt) for r in group),
                          slots=len(group) * self._prefill_width(group)):
                    self._prefill_group(group)
            if self.active:
                with span("engine.decode"):
                    self._decode()

    def _admit(self) -> List[Request]:
        """Anchor waiting requests, in order, while slots and pages last."""
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
        return group

    def _decode(self) -> None:
        """Decode one token for every active request."""
        with span("engine.prepare"):
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
        with span("engine.upload"):
            dev = [self._dev(a) for a in (tokens, seq_lens, tables, page_pos,
                                          wsh, wsl)]
        next_tokens = self.model.decode_step(self.params, *dev[:2],
                                             self.pool.pool, *dev[2:],
                                             ssm_state=self.ssm_state)
        with span("engine.wait"):
            next_tokens = next_tokens.cpu().numpy()

        with span("engine.finish"):
            self.stats.h2d_bytes += (tokens.nbytes + seq_lens.nbytes
                                     + tables.nbytes + page_pos.nbytes
                                     + wsh.nbytes + wsl.nbytes)
            self.stats.d2h_bytes += next_tokens.nbytes
            self.stats.d2h_calls += 1
            self.stats.anchored_bytes += (len(self.active)
                                          * self._kv_bytes_per_token())
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


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------

class StandardEngine(_EngineBase):
    """Contiguous KV re-copied per step + per-connection logits transfers."""
    name = "standard"
    donate_cache = False
    fused_d2h = False

    def __init__(self, model, params, *, max_batch: int = 8, max_len: int = 512,
                 parser=None, device="cuda"):
        super().__init__(model, params, max_batch=max_batch, max_len=max_len,
                         parser=parser, device=device)
        c = self.cfg
        self.cache = torch.zeros((c.num_layers, max_batch, max_len, 2,
                                  c.num_kv_heads, c.head_dim),
                                 dtype=torch.float32, device=self.device)
        self.slot_free = list(range(max_batch))

    def _cache_bytes(self) -> int:
        return self.cache.numel() * 4

    def _prefill_group(self, group: List[Request]) -> None:
        # the JAX engine pads to at least 8 tokens
        s = max(8, max(len(r.prompt) for r in group))
        tokens = np.stack([_pad_to(r.prompt, s) for r in group])
        seq_lens = np.array([len(r.prompt) for r in group], np.int32)
        first, kv = self.model.prefill_dense(
            self.params, self._dev(tokens), self._dev(seq_lens), self.max_len)
        first = first.cpu().numpy()
        now = time.perf_counter()
        for i, r in enumerate(group):
            self.cache[:, r.slot] = kv[:, i]
            r.output.append(int(first[i]))
            r.first_token_at = now
            if r.done:  # gen=1 completes at prefill
                r.done_at = now
                self.slot_free.append(r.slot)
                self.completed.append(r)
                self.stats.completed += 1
            else:
                self.active.append(r)
        self.stats.h2d_bytes += tokens.nbytes
        self.stats.d2h_bytes += first.nbytes
        self.stats.prefills += 1
        # the prefill KV lands in a fresh contiguous buffer: full copy
        self.stats.payload_copy_bytes += kv.numel() * 4
        self.stats.alloc_events += len(group)

    def step(self) -> None:
        group = []
        while self.waiting and self.slot_free:
            r = self.waiting.pop(0)
            r.slot = self.slot_free.pop(0)
            group.append(r)
        if group:
            self._prefill_group(group)
        if not self.active:
            return

        b = self.max_batch
        tokens = np.zeros(b, np.int32)
        seq_lens = np.zeros(b, np.int32)
        for r in self.active:
            tokens[r.slot] = r.output[-1]
            seq_lens[r.slot] = len(r.prompt) + len(r.output) - 1
        logits, self.cache = self.model.decode_step_dense(
            self.params, self._dev(tokens), self._dev(seq_lens), self.cache,
            donate=self.donate_cache)
        if not self.donate_cache:
            # undonated contiguous cache: the step wrote a fresh copy --
            # the standard stack's per-message payload copy
            self.stats.payload_copy_bytes += self._cache_bytes()
        # recv path: logits cross to the host
        if self.fused_d2h:
            host_logits = logits.cpu().numpy()
            self.stats.d2h_bytes += host_logits.nbytes
            self.stats.d2h_calls += 1
        else:
            host_logits = np.zeros((b, logits.shape[-1]), np.float32)
            for r in self.active:  # per-connection recv copies
                host_logits[r.slot] = logits[r.slot].cpu().numpy()
                self.stats.d2h_bytes += host_logits[r.slot].nbytes
                self.stats.d2h_calls += 1
        self.stats.h2d_bytes += tokens.nbytes + seq_lens.nbytes
        self.stats.steps += 1

        now = time.perf_counter()
        still = []
        for r in self.active:
            r.output.append(int(np.argmax(host_logits[r.slot])))
            if r.done:
                r.done_at = now
                self.slot_free.append(r.slot)
                self.completed.append(r)
                self.stats.completed += 1
            else:
                still.append(r)
        self.active = still


class CopierEngine(StandardEngine):
    """Copier: same volume, fused into one copy per step."""
    name = "copier"
    donate_cache = False
    fused_d2h = True


class StaticEngine(StandardEngine):
    """F-Stack analogue: preallocated fixed-budget buffers (fast per step,
    concurrency collapses with payload size)."""
    name = "static"
    donate_cache = True
    fused_d2h = True

    def __init__(self, model, params, *, memory_budget: int, max_len: int = 512,
                 parser=None, device="cuda"):
        c = model.cfg
        per_slot = c.num_layers * max_len * 2 * c.num_kv_heads * c.head_dim * 4
        max_batch = max(1, memory_budget // per_slot)
        super().__init__(model, params, max_batch=max_batch, max_len=max_len,
                         parser=parser, device=device)
