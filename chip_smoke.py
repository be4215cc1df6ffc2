#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the seven CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/kernels/`` (one ``nvcc`` per source, all at once) and then runs, in
order:

1. **parity** -- each datapath kernel against its plain PyTorch version on
   the card, on seeded cases at the deployment shapes and at small ragged
   ones, with every optional operand on and off: ``fused_round`` at ring
   depths ``n_buffers`` 0, 2, 3, 4 and 8 (every depth phase 11 may pick),
   also on edge rows (a payload window off its 16-byte boundary; S = 31,
   the 4-byte copy path), a 70 x 40 policy table (read from global
   memory) and pages of two tiles;
   ``selective_gather`` also at a page of 6 tokens and of two tiles;
   ``selective_copy`` also on rows at the edges of its 16-byte groups
   (``meta_len % 4`` and ``S % 4`` each 0 to 3, payloads ending at S or
   cut by it, ``-1`` slots between valid ones) in the deployment's pool,
   at a page of 6 tokens and of 2048; ``policy_match`` also at R x K = 32,
   R = 33, K = 33, payload positions past W and past ``payload_len``, an
   odd M, rows too wide to stage in shared memory, and every combination
   of keystream, live column and payload window present or absent.
   Outputs must be bit-identical (``torch.equal``, the whole pool after the
   in-place anchor included) and the pool tensor must keep its storage.
2. **e2e plaintext** -- a policy-routed ``ProxyRuntime(batched=True)`` of 64
   channels x 16 messages (256 metadata tokens, 4096-16384 payload tokens)
   over a ``LibraStack(n_shards=4, pages_per_shard=8192, page_size=1024)``:
   a 128 MiB resident pool. Run as ``fused-round`` (one kernel per round),
   ``auto`` (three kernels per round) and ``host``, the device paths twice
   in turns. Wire bytes, counters and verdicts must agree, no O(pool) sync
   may happen, every page must come back, and each device run must have
   launched its kernels.
3. **e2e hw-kTLS** -- the same with ``tls="hw"`` sockets (RX, TX and
   metadata keystreams through the kernels).
4. **trace** -- the device's busy share of one plaintext run per device
   path (``torch.profiler``).
5. **attn_parity** -- the two attention kernels against their plain
   versions on the card (``atol = rtol = 1e-4``): GQA groups 1 to 4 (and
   8 and 12 for paged attention), every head dim the wrappers take (16 to
   128), ``-1`` table slots, windows, lengths that are no multiple of a
   tile, pages of two tiles, a table of 70 slots, and the serving shapes of
   phase 6 (paged attention also at B=1).
6. **serve** -- ``LibraEngine`` serving ``phi4-mini-3.8b`` at full width
   and depth (3.84 B float32 parameters from a fixed seed on the card): 16
   requests of 1024 tokens (8-token header) in two waves of 8, 32 new
   tokens each, run once through the kernels (``attn_impl='auto'``) and
   once through their plain versions (``'ref'``) on the same parameters.
   ``EngineStats``, ``CopyCounters`` and the output tokens must be
   identical (a token may differ only where the plain run's top-2 logit
   margin is below 1e-3 of the logits' spread), every page must come
   back, and each kernel must have launched. Prints tokens/s, p99 latency,
   time to first token, peak device memory, launches, and a profiler split
   of one decode step.
7. **mlstm_parity** -- the mLSTM kernel against the plain chunked version
   on the card, ``h`` and the final ``(C, n, m)``: the JAX package's test
   shapes (``atol = rtol = 5e-4``), its gate extremes (3e-3), S that is no
   multiple of the chunk, at least one case for every ``(dh, chunk)`` the
   wrapper instantiates (``HEAD_DIMS x CHUNKS``, 12 pairs), and the xLSTM
   run's shape (B=8, H=4, S=4096, dh=512, chunk 64).
8. **xlstm_serve** -- ``XLSTMModel`` of ``xlstm-350m`` at full width and
   depth (528 M float32 parameters from a fixed seed): 8 prompts of 4096
   tokens, one ``prefill`` and 31 greedy ``decode_step``s, once through
   the kernel (``mlstm_impl='auto'``) and once through the plain version
   (``'ref'``). Tokens must be identical under the near-tie rule of phase
   6, the decode state after prefill must lie no farther from that of a
   run whose scans are computed in float64 than twice the plain run's
   distance, a control whose scans take bfloat16-rounded inputs must fail
   that rule, and the kernel must have launched once per mLSTM block
   (21). Prints each run's ratio to the plain run's distance, prefill
   seconds, ms per decode step, tokens/s, peak device memory and a
   profiler split of the prefill.
9. **timing** -- each kernel, its plain version and (where one exists) a
   single PyTorch library call at the main path's shapes: CUDA events
   around each launch, L2 flushed before it, median of 30 launches (the
   datapath kernels also after a 64 MB read that leaves the L2 clean,
   ``fused_round`` at each ring depth, ``selective_gather`` beside a
   ``copy_`` of as many bytes as it writes; a kernel that returns at once,
   the timing's floor, on a line of its own and beside the
   ``selective_copy`` and ``policy_match`` rows); the
   bound is the larger of the bytes the function must move over 3.35 TB/s
   and its operations over the card's peak for their type (int32 for the
   datapath, float32 FMA for paged attention; for flash attention and the
   mLSTM scan three TF32 tensor-core products per float32 product, with
   the float32-FMA bound beside it as ``fp32_fma_bound_ms``).
10. **cluster** (run right after phase 4) -- phase 2's deployment as a
   ``LibraCluster`` of four workers, each with its own 128 MiB resident
   pool (512 MiB on the card) and a clone of the policy table, under
   ``ClusterRuntime(work_stealing=False)``. Channel i's source is on
   worker i % 4; both destinations are on the next worker for the first
   16 channels (25 % of the flows cross workers, each handoff a zero-copy
   grant gathered out of the owner's pool) and on its own worker
   otherwise. Plaintext as ``fused-round``, ``auto`` and ``host`` under
   ``run()`` and as ``fused-round`` and ``host`` under
   ``run_parallel(threads=True)``; hw-kTLS as ``fused-round`` and
   ``host`` under ``run()``. Within a TLS mode wire bytes, aggregate
   ``CopyCounters``, policy verdicts and cluster stats must be identical;
   wire bytes and counters must equal a single ``LibraStack`` run of the
   same traffic; grants must happen; every worker of a device run must
   run device rounds with no pool sync, no host gather and no device
   fallback, and launch the kernels of its path (and no others); and
   shutdown must find every pool free with no grant pin left. Then three
   directed cases: (a) every flow crossing to a worker above its
   watermark (each handoff a one-copy read of the owner's device-truth
   rows), ``fused-round`` against ``host``; (b) a message taken in by a
   ``fused-round`` round, granted, and its owner killed: the grant is
   copied out of the dying pool and transmits byte for byte; (c) the
   chaos scenario of ``scripts/check_failover_recovery_torch.py`` as
   ``fused-round`` rounds, under ``run()`` and under threads. Prints each
   run's seconds, rounds/s and msgs/s, the threads' per-worker seconds,
   the grant, copy and kill stats and the launches per kernel.
11. **depth** (run right after phase 10) -- the fused round's ring depth
   on the main path. ``kernels/dma_profile.profile_fused_depths`` on the
   card at ``n_buffers`` 0, 2, 3, 4 and 8, plaintext and with both
   keystreams, at two shapes: the datapath cell's round (64 rows x 17
   tasks, pages of 1024 tokens, 16 pages a row, 256 metadata tokens) and
   the N = 256 point of ``benchmarks/bench_batched_datapath.py`` (256
   rows, 4352 tasks); each depth's ring, best wall-clock round and best
   CUDA-event kernel time, ``dma_compute_profile`` at the picked depth and
   ``auto_buffer_depth``'s pick (the least kernel time). Then phases 2 and 3's ``fused-round``
   runs with ``stack.pool.fused_buffers`` at 0, at the depth picked at
   the N = 256 shape with both keystreams, and at the depth
   ``auto_buffer_depth`` returns under ``LIBRA_FUSED_BUFFERS=4`` (which
   must be 4), beside ``host``: wire bytes, counters and verdicts
   identical to ``host`` and to the default depth's run, ``xfer``
   identical to the default depth's, and every ``fused_round`` launch of
   a run at the ring depth its ``fused_buffers`` names
   (``selective_copy.FUSED_DEPTHS``).

Float32 products of the plain versions run in full float32 (TF32 off).
Each phase prints one JSON line. Then come the card's name and power limit
(``nvidia-smi``), the ``{"kernels": [...]}`` line, and last ``{"ok": true,
"device": {...}}``. Any failure exits non-zero before the last line; with
no CUDA device, or outside a checkout, it fails at once.

``python3 chip_smoke.py --mlstm-ab [--serve] A.cu B.cu ...`` runs only the
mLSTM scan's checks for other versions of ``csrc/mlstm_scan.cu`` (an
earlier commit's, unpacked under ``build/``; stages of a rewrite): it
builds each source into its own library, runs phase 7 against each (and
phase 8 through each, with ``--serve``) and times each at the run's shape
as phase 9 does, in turns (A B ... B A, twice), in one process on one
card.

``python3 chip_smoke.py --flash-ab A.cu B.cu ...`` does the same for
versions of ``csrc/flash_attention.cu``: the ``flash_attention`` cases of
phase 5 against each build and phase 9's prefill-layer timing of each, in
turns. ``python3 chip_smoke.py --paged-ab A.cu B.cu ...`` does the same
for versions of ``csrc/paged_attention.cu``: the ``paged_attention`` cases
of phase 5 and phase 9's decode-layer timing, with the row's bytes bound,
each build's TB/s and its share of the bound. ``--gather-ab`` and
``--fused-ab`` do the same for ``csrc/selective_gather.cu`` and
``csrc/fused_round.cu``: the kernel's cases of phase 1 and the
deployment's timing under both flushes, beside a kernel that returns at
once (and, for the gather, ``index_select`` of its rows and a ``copy_`` of
as many bytes as it writes; the fused round at ring depths 0, 2, 3, 4 and
8; a ``fused_round.cu`` whose entry point has no depth argument runs every
depth alike). ``--copy-ab`` and ``--policy-ab`` do the same for
``csrc/selective_copy.cu`` and ``csrc/policy_match.cu``: the kernel's
cases of phase 1 and the deployment's timing, plain and with the
keystream, under both flushes, beside a kernel that returns at once (and
for the copy a ``copy_`` of as many bytes as it writes). A header next
to a source is found before the one in ``csrc/``, so an earlier commit's
sources can bring their own. The modes compile with ``-I
src/repro_torch/kernels/csrc``, so a copy under ``build/`` finds the
shared headers, and print each build's ``ptxas -v`` and
SASS opcode mix of its run-shape instantiation.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
# 32-bit integer add, compare, min/max and logical ops issue at 64 results
# per clock per SM on compute capability 9.0 (CUDA C++ Programming Guide,
# "Throughput of Native Arithmetic Instructions"); the kernels' operations
# are of that type. The peak is this times the SM count times the card's
# maximum SM clock, both read from the card.
INT32_OPS_PER_SM_CLOCK = 64
# float32 FMA: 128 lanes per SM, 2 operations each, per clock (the same
# table); the attention kernels' operations are of that type.
FP32_OPS_PER_SM_CLOCK = 256
# TF32 on the tensor cores, dense: 1024 multiply-adds per SM per clock
# (H100 SXM: 494.7 TFLOP/s at the data sheet's 1830 MHz boost, 132 SMs).
# The flash attention and mLSTM kernels take each float32 product as three
# TF32 products (hi.hi + hi.lo + lo.hi), so their bound is three times the
# function's operations at this rate; the float32-FMA bound is printed
# beside it.
TF32_OPS_PER_SM_CLOCK = 2048
TF32_SPLIT_PASSES = 3
ATTN_TOL = dict(atol=1e-4, rtol=1e-4)
# the JAX package's bars for its Pallas mLSTM kernel (tests/test_kernels.py)
MLSTM_TOL = dict(atol=5e-4, rtol=5e-4)
MLSTM_TOL_EXTREME = dict(atol=3e-3, rtol=3e-3)
# xLSTM decode state after prefill: 24 blocks and 3 x 4096 sLSTM steps
# amplify the scans' float32 rounding, so the kernel run is held against a
# run whose scans are float64, no farther from it than this many times the
# plain float32 run is. Sound kernel runs read at most 1.17 (PERF.md,
# section 6); a run whose scans take bfloat16-rounded inputs must exceed it
XLSTM_STATE_FACTOR = 2.0
TIMED_RUNS = 30
SPIN_CYCLES = 1_000_000     # ~0.5 ms at H100 clocks: longer than an enqueue

KERNELS = {
    "selective_copy": "src/repro/kernels/selective_copy.py:94",
    "selective_gather": "src/repro/kernels/selective_copy.py:364",
    "policy_match": "src/repro/kernels/selective_copy.py:265",
    "fused_round": "src/repro/kernels/selective_copy.py:554",
    "paged_attention": "src/repro/kernels/paged_attention.py:84",
    "flash_attention": "src/repro/kernels/flash_attention.py:82",
    "mlstm_scan": "src/repro/kernels/mlstm_scan.py:73",
}
DATAPATH = ("selective_copy", "selective_gather", "policy_match",
            "fused_round")
# fused_round's ring depths held and timed: 0 is the wrapper's default
FUSED_DEPTHS = (0, 2, 3, 4)
# ring depths phase 11 profiles, any of which it may pick and run the
# main path at: each is held against the plain version in phase 1
PROFILE_DEPTHS = FUSED_DEPTHS + (8,)
# kernels each datapath run must launch, and kernels it must not: a fused
# round anchors and matches in its one launch, but sends its speculation
# missed (policy reroutes, drops, cross-worker grants) still gather in
# their own launch
LAUNCH_EXPECT = {"fused-round": (("fused_round",),
                                 ("selective_copy", "policy_match")),
                 "auto": (("selective_copy", "policy_match",
                           "selective_gather"), ("fused_round",)),
                 "host": ((), DATAPATH)}


@dataclasses.dataclass(frozen=True)
class Size:
    """The deployment the smoke run drives (see PERF.md, Cells)."""
    n_shards: int = 4
    pages_per_shard: int = 8192     # 32768 pages + scratch = 128 MiB int32
    page: int = 1024                # 4 KiB of int32 tokens
    channels: int = 64
    msgs: int = 16
    meta_tokens: int = 256          # the parser's 256-token lookahead
    payload_lo: int = 4096
    payload_hi: int = 16384

    @property
    def pool_rows(self) -> int:
        return self.n_shards * self.pages_per_shard + 1

    @property
    def pps(self) -> int:
        return self.payload_hi // self.page

    @property
    def meta_max(self) -> int:
        return self.meta_tokens

    def meta_app(self, tls) -> int:
        """Application metadata tokens per message: the whole metadata
        prefix (3 framing tokens, plus the 5-token record header under
        kTLS) is ``meta_tokens``, so it fits the parser's lookahead."""
        from repro_torch.core.crypto import REC_HEADER
        return self.meta_tokens - 3 - (REC_HEADER if tls else 0)


SMALL = dict(b=5, page=8, pps=3, meta_max=5)


@dataclasses.dataclass(frozen=True)
class ServeSize:
    """The serving run (see PERF.md, Cells): phi4-mini-3.8b at full width
    and depth, the engine's default page size."""
    arch: str = "phi4-mini-3.8b"
    seed: int = 0
    requests: int = 16
    max_batch: int = 8
    prompt: int = 1024
    header: int = 8
    gen: int = 32
    page: int = 16
    #: decode context of the paged_attention timing: the middle of a wave
    timing_context: int = 1040

    @property
    def max_len(self) -> int:        # launch/serve.py: prompt + gen + 8
        return self.prompt + self.gen + 8

    @property
    def pps(self) -> int:            # LibraEngine: max_len // page + 2
        return self.max_len // self.page + 2

    @property
    def pool_pages(self) -> int:     # LibraEngine: max_batch * pps + 4
        return self.max_batch * self.pps + 4


@dataclasses.dataclass(frozen=True)
class XlstmSize:
    """The xLSTM run (see PERF.md, Cells): xlstm-350m at full width and
    depth, 8 prompts of 4096 tokens, one prefill and 31 decode steps."""
    arch: str = "xlstm-350m"
    seed: int = 0
    batch: int = 8
    prompt: int = 4096
    gen: int = 32
    chunk: int = 64


class SmokeError(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# phase 1: parity
# ---------------------------------------------------------------------------

def max_abs(a, b) -> int:
    if a is None and b is None:
        return 0
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max().item())


def widen(case: dict, rows: int, rng, np):
    """Place a generated case's pool pages at random distinct rows of a
    deployment-sized pool (the last row stays the scratch row)."""
    tables = case["tables"]
    used = np.unique(tables[tables >= 0])
    dest = rng.choice(rows - 1, size=len(used), replace=False)
    remap = np.full(int(case["pool"].shape[0]), -1, np.int64)
    remap[used] = dest
    big = rng.integers(0, 5, (rows, case["pool"].shape[1]), dtype=np.int32)
    big[dest] = case["pool"][used]
    out = dict(case)
    out["pool"] = big
    out["tables"] = np.where(tables >= 0, remap[np.maximum(tables, 0)],
                             -1).astype(np.int32)
    return out


def selcopy_dict(t):
    keys = ("stream", "meta_len", "total_len", "pool", "tables", "keystream")
    return dict(zip(keys, t))


def run_pair(fn_kernel, fn_plain, pool_k, pool_r, torch):
    """Run a kernel and its plain version on copies of one pool; return
    (kernel outputs, plain outputs) as tuples, checking pool storage."""
    ptr = pool_k.data_ptr() if pool_k is not None else None
    out_k = fn_kernel(pool_k)
    out_r = fn_plain(pool_r)
    torch.cuda.synchronize()
    if pool_k is not None:
        check(pool_k.data_ptr() == ptr, "pool storage moved")
    return out_k, out_r


def parity(size: Size, dev, torch, np, ops, tt, kernels=DATAPATH):
    rng = np.random.default_rng(11)
    results = []

    def record(kernel, label, outs_k, outs_r):
        errs = [max_abs(a, b) for a, b in zip(outs_k, outs_r)]
        same = all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(outs_k, outs_r))
        results.append(dict(kernel=kernel, case=label, equal=same,
                            max_abs_err=max(errs)))
        check(same, f"{kernel} [{label}] differs from its plain version "
                    f"(max abs err {max(errs)})")

    big = dict(b=size.channels, page=size.page, pps=size.pps,
               meta_max=size.meta_max)
    # -- selective_copy: deployment, small ragged, edge rows; rows at the
    # edges of the kernel's 16-byte groups (meta_len % 4 in 0..3, S % 4 in
    # 0..3, payloads ending at S or cut by it, -1 slots between valid
    # ones) at the deployment's page in its pool, at a page of 6 tokens
    # (the word path) and of 2048 (two groups a thread) ----------------
    cases = [] if "selective_copy" not in kernels else [
        ("deploy", widen(selcopy_dict(tt.selcopy_crypto_case(rng, **big)),
                         size.pool_rows, rng, np), size.meta_max),
        ("small", selcopy_dict(tt.selcopy_crypto_case(rng, **SMALL)),
         SMALL["meta_max"]),
        ("edge", selcopy_dict(tt.edge_rows_case()), 8)] + [
        (f"group-edges/S%4={tail}", widen(selcopy_dict(tt.selcopy_edge_case(
            page=size.page, pps=size.pps, meta_max=size.meta_max,
            s_tail=tail)), size.pool_rows, rng, np), size.meta_max)
        for tail in range(4)] + [
        (f"odd-page/S%4={tail}", selcopy_dict(tt.selcopy_edge_case(
            page=6, pps=3, meta_max=8, s_tail=tail)), 8)
        for tail in (0, 1)] + [
        ("two-group-page", selcopy_dict(tt.selcopy_edge_case(
            page=2048, pps=2, meta_max=16)), 16)]
    for label, case, meta_max in cases:
        for crypto in (False, True):
            c = tt.to_torch(case, dev)
            ks = c["keystream"] if crypto else None

            def run(impl, pool):
                return ops.selective_copy(
                    c["stream"], c["meta_len"], c["total_len"], pool,
                    c["tables"], meta_max=meta_max, impl=impl, keystream=ks)
            pk, pr = c["pool"], c["pool"].clone()
            ok, orr = run_pair(lambda p: run("cuda", p),
                               lambda p: run("ref", p), pk, pr, torch)
            check(ok[1] is pk, "selective_copy returned another pool")
            record("selective_copy", f"{label}/{'ks' if crypto else 'plain'}",
                   ok, orr)
    # -- selective_gather: deployment, small, a page of 6 tokens (no
    # 16-byte row alignment: the 4-byte copy path), pages of two tiles ---
    gcases = [] if "selective_gather" not in kernels else [
        ("deploy", tt.selgather_case(
            rng, b=size.channels, page=size.page, pps=size.pps,
            p_total=size.pool_rows - 1)),
        ("small", tt.selgather_case(rng, b=SMALL["b"], page=SMALL["page"],
                                    pps=SMALL["pps"])),
        ("odd-page", tt.selgather_case(rng, b=5, page=6, pps=3)),
        ("two-tile-page", tt.selgather_case(rng, b=3, page=2048, pps=2))]
    for label, case in gcases:
        pool, tables, lengths, ks = tt.to_torch(case, dev)
        for crypto in (False, True):
            k = ks if crypto else None
            ok, orr = run_pair(
                lambda p: (ops.selective_gather(p, tables, lengths,
                                                impl="cuda", keystream=k),),
                lambda p: (ops.selective_gather(p, tables, lengths,
                                                impl="ref", keystream=k),),
                pool, pool, torch)
            record("selective_gather",
                   f"{label}/{'ks' if crypto else 'plain'}", ok, orr)
    # -- policy_match: the deployment table, a wide table, small; R x K =
    # 32 (one round of the lanes), R = 33 (two chunks of rules, the match
    # in the second), K = 33, payload positions past W and past
    # payload_len, an odd M (4-byte copies), and rows too wide to stage
    # in shared memory (the payload window, then the metadata) ----------
    pcases = [] if "policy_match" not in kernels else [
        ("deploy", tt.policy_payload_case(
            rng, b=size.channels, meta_max=size.meta_max, r=3, k=1,
            w=size.page), 3),
        ("wide", tt.policy_payload_case(rng, b=9, meta_max=40, r=70, k=40,
                                        w=16), 70),
        ("small", tt.policy_payload_case(rng, b=6, meta_max=12, r=7, k=3,
                                         w=8), 7),
        ("one-round", tt.policy_payload_case(rng, b=8, meta_max=16, r=8,
                                             k=4, w=8), 8),
        ("r33-k33", tt.policy_edge_case(rng, b=12, meta_max=24, r=33, k=33,
                                        w=16), 33),
        ("r33-last", tt.policy_edge_case(rng, b=12, meta_max=24, r=33, k=1,
                                         w=16, fail_first=32), 33),
        ("k33", tt.policy_edge_case(rng, b=12, meta_max=24, r=4, k=33,
                                    w=16), 4),
        ("payload-edges", tt.policy_edge_case(rng, b=10, meta_max=12, r=6,
                                              k=2, w=8), 6),
        ("odd-m", tt.policy_payload_case(rng, b=7, meta_max=13, r=7, k=3,
                                         w=9), 7),
        ("unstaged-window", tt.policy_payload_case(
            rng, b=9, meta_max=64, r=5, k=3, w=16384), 5),
        ("unstaged-meta", tt.policy_payload_case(rng, b=5, meta_max=3101,
                                                 r=5, k=3, w=8), 5)]
    # each of keystream, live and payload absent and present
    variants = {"plain": (), "ks": ("ks",), "live": ("live",),
                "payload": ("payload",), "ks+live": ("ks", "live"),
                "ks+payload": ("ks", "payload"),
                "live+payload": ("live", "payload"),
                "all": ("ks", "live", "payload")}
    for label, case, r in pcases:
        meta, ml, off, lo, hi, ks, pw, pln = case
        ml = ml.copy()
        ml[0] = 0                                   # an empty metadata row
        live = tt.policy_live_column(rng, r)
        t = tt.to_torch(dict(meta=meta, ml=ml, off=off, lo=lo, hi=hi, ks=ks,
                             pw=pw, pln=pln, live=live), dev)
        for vname, opts in variants.items():
            kw = dict(keystream=t["ks"] if "ks" in opts else None,
                      live=t["live"] if "live" in opts else None)
            if "payload" in opts:
                kw.update(payload=t["pw"], payload_len=t["pln"])
            ok, orr = run_pair(
                lambda _p: (ops.policy_match(t["meta"], t["ml"], t["off"],
                                             t["lo"], t["hi"], impl="cuda",
                                             **kw),),
                lambda _p: (ops.policy_match(t["meta"], t["ml"], t["off"],
                                             t["lo"], t["hi"], impl="ref",
                                             **kw),),
                None, None, torch)
            record("policy_match", f"{label}/{vname}", ok, orr)
    if pcases:
        t = tt.to_torch(dict(meta=pcases[2][1][0], ml=pcases[2][1][1],
                             none=np.zeros((0, 3), np.int32)), dev)
        ok, orr = run_pair(
            lambda _p: (ops.policy_match(t["meta"], t["ml"], t["none"],
                                         t["none"], t["none"], impl="cuda"),),
            lambda _p: (ops.policy_match(t["meta"], t["ml"], t["none"],
                                         t["none"], t["none"], impl="ref"),),
            None, None, torch)
        record("policy_match", "no-rules", ok, orr)
    # -- fused_round ---------------------------------------------------------
    operand_sets = {
        "none": (),
        "crypto": ("keystream", "tx_keystream"),
        "policy": ("cond_off", "cond_lo", "cond_hi"),
        "crypto+policy+live": ("keystream", "tx_keystream", "cond_off",
                               "cond_lo", "cond_hi", "live"),
        "all": ("keystream", "tx_keystream", "cond_off", "cond_lo",
                "cond_hi", "live", "meta_ks"),
    }
    # with a policy table and both keystreams: edge rows (meta_len 0, 5
    # and 8: a window off its 16-byte boundary), the same with S = 31 (the
    # 4-byte copy path), a 70 x 40 table past the shared-memory budget,
    # and pages of two tiles
    with_policy = {k: operand_sets[k] for k in ("crypto+policy+live", "all")}
    fcases = [] if "fused_round" not in kernels else [
        ("deploy", widen(tt.fused_round_case(rng, r=3, k=1, **big),
                         size.pool_rows, rng, np), size.meta_max,
         operand_sets),
        ("small", tt.fused_round_case(rng, r=6, k=3, **SMALL),
         SMALL["meta_max"], operand_sets),
        ("edge", tt.edge_fused_round_case(), 8, with_policy),
        ("edge-odd-s", tt.edge_fused_round_case(meta_max=7), 7, with_policy),
        ("wide-table", tt.fused_round_case(rng, b=9, page=16, pps=3,
                                           meta_max=40, r=70, k=40), 40,
         with_policy),
        ("two-tile-page", tt.fused_round_case(rng, b=3, page=2048, pps=2,
                                              meta_max=16), 16, with_policy)]
    for label, case, meta_max, sets in fcases:
        for oname, keys in sets.items():
            c = tt.to_torch(case, dev)
            kw = {k: c[k] for k in keys}

            def run(impl, pool, depth=0):
                return ops.fused_round(
                    c["stream"], c["meta_len"], c["total_len"], pool,
                    c["tables"], meta_max=meta_max, impl=impl,
                    n_buffers=depth, **kw)
            want = run("ref", c["pool"].clone())
            for depth in PROFILE_DEPTHS:    # bit-identical at every depth
                pk = c["pool"].clone()
                ok, orr = run_pair(lambda p: run("cuda", p, depth),
                                   lambda _p: want, pk, None, torch)
                check(ok[1] is pk, "fused_round returned another pool")
                record("fused_round", f"{label}/{oname}/n_buffers={depth}",
                       ok, orr)
    emit({"phase": "parity", "cases": len(results),
          "all_equal": all(r["equal"] for r in results),
          "max_abs_err": {k: max(r["max_abs_err"] for r in results
                                 if r["kernel"] == k) for k in kernels}})
    return results


# ---------------------------------------------------------------------------
# phases 2-3: end to end
# ---------------------------------------------------------------------------

def policy_table(tls, core):
    """The deployment's three rules: a metadata drop, a payload-prefix
    forward and a metadata forward."""
    from repro_torch.core.crypto import REC_HEADER
    from repro_torch.core.policy import payload_at

    off = (REC_HEADER if tls else 0) + 3
    return core.PolicyTable([
        core.rule(core.drop(), core.between(off, 196, 199)),
        core.rule(core.forward(1), payload_at(0, 1950, 2000)),
        core.rule(core.forward(0), core.between(off, 100, 199)),
    ])


def load_channel(size: Size, tls, src, rng, np, core) -> None:
    """Deliver one channel's ``size.msgs`` messages into ``src``."""
    frames = [core.build_message(
        rng.integers(100, 200, size.meta_app(tls)),
        rng.integers(1000, 2000,
                     int(rng.integers(size.payload_lo,
                                      size.payload_hi + 1))))
        for _ in range(size.msgs)]
    src.deliver(src.tls.seal_frames(frames, src.parser.inner) if tls
                else np.concatenate(frames))


def build_run(size: Size, impl: str, tls, dev, np, core):
    """The deployment's stack, policy table and loaded runtime."""
    stack = core.LibraStack(n_shards=size.n_shards,
                            pages_per_shard=size.pages_per_shard,
                            page_size=size.page, secret=b"chip-smoke",
                            device=dev)
    table = policy_table(tls, core)
    # batch_tile=0: each round is ONE recv/forward pass over every ready
    # channel (B = 64); the adaptive tile would split such page-heavy
    # rounds into tiles of a few messages
    rt = core.ProxyRuntime(stack, tick_every=32, policy=table, batched=True,
                           batch_impl=impl, batch_tile=0)
    rng = np.random.default_rng(2026)
    for i in range(size.channels):
        src = stack.socket("length-prefixed", tls=tls)
        dsts = [stack.socket("length-prefixed", tls=tls) for _ in range(2)]
        rt.channel(src, dsts, name=f"ch{i}")
        load_channel(size, tls, src, rng, np, core)
    return stack, rt, table


def same_wires(a, b, np) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def check_device_plane(tag: str, impl: str, xfers, counters, launches,
                       workers) -> None:
    """No fallback hides the card: no worker in ``workers`` synced its
    pool or gathered a batched round on the host; on a device path each
    ran device rounds and none fell back to the host; and the expected
    kernels (and no others) launched."""
    if impl != "host":
        check(counters["device_fallbacks"] == 0,
              f"{tag}: rounds fell back to the host")
    for i in workers:
        x = xfers[i]
        if impl != "host":
            check(x["device_rounds"] > 0, f"{tag}: worker {i} ran no "
                  "device round")
        check(x["pool_syncs"] == 0, f"{tag}: worker {i} synced its pool")
        check(x.get("host_gathers", 0) == 0,
              f"{tag}: worker {i} gathered {x.get('host_gathers')} "
              "batched rounds on the host")
    must, must_not = LAUNCH_EXPECT[impl]
    for k in must:
        check(launches[k] > 0, f"{tag}: kernel {k} was never launched")
    for k in must_not:
        check(launches[k] == 0, f"{tag}: kernel {k} launched "
              f"{launches[k]} times")


def e2e_run(size: Size, impl: str, tls, dev, torch, np, core, kern,
            fused_buffers: int = 0):
    stack, rt, table = build_run(size, impl, tls, dev, np, core)
    stack.pool.fused_buffers = fused_buffers
    # the one-time residency upload (128 MiB) is set-up, timed apart
    t0 = time.perf_counter()
    if impl != "host":
        stack.pool._ensure_device()
    torch.cuda.synchronize()
    resident_s = time.perf_counter() - t0
    kern.reset_launches()
    t0 = time.perf_counter()
    rt.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    fused_depths = dict(kern.FUSED_DEPTHS)
    wires = [d.tls.open_wire(d.tx_wire()) if tls else d.tx_wire()
             for ch in rt.channels for d in ch.dsts]
    out = dict(impl=impl, rounds=rt.rounds, seconds=dt,
               resident_init_seconds=resident_s,
               rounds_per_s=rt.rounds / dt,
               msgs=rt.messages_forwarded(),
               msgs_per_s=rt.messages_forwarded() / dt,
               launches=launches, fused_depths=fused_depths,
               fused_buffers=stack.pool.fused_buffers,
               xfer=dict(stack.pool.xfer),
               counters=dataclasses.asdict(stack.counters),
               verdicts=table.summary())
    rt.shutdown()
    check(stack.alloc.free_pages == stack.alloc.total_pages,
          f"{impl}: pages leaked after shutdown")
    return out, wires


def e2e(size: Size, tls, dev, torch, np, core, kern):
    # device paths run twice, in turns (fused, auto, host, auto, fused), so
    # process warm-up and drift do not land on one path
    runs, wires = [], []
    for impl in ("fused-round", "auto", "host", "auto", "fused-round"):
        r, w = e2e_run(size, impl, tls, dev, torch, np, core, kern)
        runs.append(r)
        wires.append(w)
    base_i = next(i for i, r in enumerate(runs) if r["impl"] == "host")
    base = runs[base_i]
    check(base["msgs"] > 0, "nothing was forwarded")
    for r, w in zip(runs, wires):
        impl = r["impl"]
        tag = f"{tls or 'plaintext'}/{impl}"
        check(same_wires(w, wires[base_i], np),
              f"{tag}: wire bytes differ from the host run")
        check(r["counters"] == base["counters"],
              f"{tag}: CopyCounters differ from the host run")
        check(r["verdicts"] == base["verdicts"],
              f"{tag}: policy verdicts differ from the host run")
        check(r["msgs"] == base["msgs"], f"{tag}: message count differs")
        x = r["xfer"]
        check(x["donated_rounds"] == x["device_rounds"],
              f"{tag}: donated_rounds != device_rounds")
        check_device_plane(tag, impl, [x], r["counters"], r["launches"],
                           (0,))
    summary = {}
    for r in runs:
        row = summary.setdefault(r["impl"], {"rounds": r["rounds"],
                                             "launches": r["launches"],
                                             "xfer": r["xfer"]})
        for k in ("seconds", "resident_init_seconds", "rounds_per_s",
                  "msgs_per_s"):
            row.setdefault(k, []).append(r[k])
    emit({"phase": f"e2e_{tls or 'plaintext'}", "identical": True,
          "msgs": base["msgs"], "rule_hits": base["verdicts"]["rule_hits"],
          "order": [r["impl"] for r in runs], "runs": summary})
    return runs


def trace(size: Size, dev, torch, np, core):
    """Device busy share of one plaintext run per device path, from a
    ``torch.profiler`` trace (device time summed over every kernel and
    copy, over the run's host wall time)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for impl in ("fused-round", "auto"):
        stack, rt, _table = build_run(size, impl, None, dev, np, core)
        stack.pool._ensure_device()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rt.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rt.shutdown()
        by_name = {}
        for e in prof.key_averages():
            # device-side events only (kernels, copies, memsets): the CPU
            # ops that launched them carry the same time again
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                by_name[e.key] = e.device_time_total
        device_us = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[impl] = {"wall_s": wall, "device_s": device_us / 1e6,
                     "device_busy_share": device_us / 1e6 / wall,
                     "rounds": rt.rounds,
                     "top_device_us": {k[:60]: v for k, v in top}}
    emit({"phase": "trace", "runs": out})
    return out


# ---------------------------------------------------------------------------
# phase 10: the four-worker cluster
# ---------------------------------------------------------------------------

CLUSTER_WORKERS = 4
#: channels whose two destinations sit on the next worker: 25 % of 64
CROSS_CHANNELS = 16


def build_cluster(size: Size, impl: str, tls, dev, np, core,
                  fallback: bool = False):
    """The deployment as ``CLUSTER_WORKERS`` workers, each with its own
    128 MiB resident pool and a clone of the policy table. Channel i's
    source is on worker i % 4; its two destinations are on the next worker
    for the first ``CROSS_CHANNELS`` channels and on its own otherwise.
    ``fallback``: sources on workers 0 and 1, destinations on 2 and 3,
    whose pools sit above their watermark (every grant becomes a copy)."""
    w = CLUSTER_WORKERS
    cl = core.LibraCluster(w, n_shards=size.n_shards,
                           pages_per_shard=size.pages_per_shard,
                           page_size=size.page, secret=b"chip-smoke",
                           device=dev)
    if fallback:
        for dw in (2, 3):
            cl.workers[dw].high_watermark = 0.0
    crt = core.ClusterRuntime(cl, work_stealing=False,
                              policy=policy_table(tls, core), batched=True,
                              batch_impl=impl, batch_tile=0, tick_every=32)
    rng = np.random.default_rng(2026)
    dsts = []
    for i in range(size.channels):
        if fallback:
            sw, dw = i % 2, 2 + i % 2
        else:
            sw = i % w
            dw = (sw + 1) % w if i < CROSS_CHANNELS else sw
        src = cl.socket("length-prefixed", worker=sw, tls=tls)
        pair = [cl.socket("length-prefixed", worker=dw, tls=tls)
                for _ in range(2)]
        crt.channel(src, pair, name=f"ch{i}")
        dsts += pair
        load_channel(size, tls, src, rng, np, core)
    return cl, crt, dsts


def cluster_run(size: Size, impl: str, tls, executor: str, dev, torch, np,
                core, kern, fallback: bool = False):
    cl, crt, dsts = build_cluster(size, impl, tls, dev, np, core, fallback)
    # the one-time residency uploads (4 x 128 MiB) are set-up, timed apart
    t0 = time.perf_counter()
    if impl != "host":
        for w in cl.workers:
            w.pool._ensure_device()
    torch.cuda.synchronize()
    resident_s = time.perf_counter() - t0
    kern.reset_launches()
    t0 = time.perf_counter()
    worker_s = None
    if executor == "threads":
        _msgs, worker_s = crt.run_parallel(threads=True)
    else:
        crt.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    wires = [d.tls.open_wire(d.tx_wire()) if tls else d.tx_wire()
             for d in dsts]
    agg = cl.counters_aggregate()
    worker_rounds = [rt.rounds for rt in crt.runtimes]
    rounds = crt.rounds if executor == "run" else max(worker_rounds)
    msgs = crt.messages_forwarded()
    out = dict(impl=impl, executor=executor, rounds=rounds,
               worker_rounds=worker_rounds, seconds=dt,
               resident_init_seconds=resident_s,
               rounds_per_s=rounds / dt, msgs=msgs, msgs_per_s=msgs / dt,
               worker_seconds=worker_s, launches=launches,
               xfer=[dict(w.pool.xfer) for w in cl.workers],
               counters=dataclasses.asdict(agg), snapshot=agg.snapshot(),
               verdicts=crt.policy_summary()["aggregate"],
               stats=dict(cl.stats))
    tag = f"cluster/{tls or 'plaintext'}/{impl}/{executor}"
    check_device_plane(tag, impl, out["xfer"], out["counters"], launches,
                       (0, 1) if fallback else range(CLUSTER_WORKERS))
    crt.shutdown()      # assert_no_leaks: every pool free, no grant pin
    return out, wires


def cluster_identity(size: Size, tls, runs, dev, torch, np, core, kern):
    """The ``runs`` ((impl, executor) pairs) of one TLS mode: identical
    wire bytes, counters and verdicts across them, and wire bytes and
    counters equal to a single-stack run of the same traffic."""
    single, single_wires = e2e_run(size, "host", tls, dev, torch, np, core,
                                   kern)
    single_snap = core.CopyCounters(**single["counters"]).snapshot()
    out, base_w = [], None
    for impl, executor in runs:
        r, w = cluster_run(size, impl, tls, executor, dev, torch, np, core,
                           kern)
        gc.collect()
        tag = f"cluster/{tls or 'plaintext'}/{impl}/{executor}"
        if out:
            base = out[0]
            check(same_wires(w, base_w, np), f"{tag}: wire bytes differ "
                  f"from {base['impl']}/{base['executor']}")
            for k in ("counters", "verdicts", "msgs", "stats"):
                check(r[k] == base[k], f"{tag}: {k} differ from "
                      f"{base['impl']}/{base['executor']}")
        else:
            base_w = w
        check(r["msgs"] > 0, f"{tag}: nothing was forwarded")
        check(r["stats"]["grants"] > 0, f"{tag}: no cross-worker grant")
        check(r["stats"]["copies"] == 0, f"{tag}: a grant fell back to a "
              "copy below the watermark")
        check(same_wires(w, single_wires, np),
              f"{tag}: wire bytes differ from the single-stack run")
        check(tuple(r["snapshot"]) == tuple(single_snap),
              f"{tag}: counters differ from the single-stack run")
        out.append(r)
    return out


def cluster_fallback(size: Size, dev, torch, np, core, kern):
    """Directed case (a): every flow crosses to a worker above its
    watermark, so each handoff is the one-copy fallback, which reads the
    owner's device-truth rows back out of its pool."""
    small = dataclasses.replace(size, channels=CROSS_CHANNELS)
    res = {}
    wires = {}
    for impl in ("fused-round", "host"):
        r, w = cluster_run(small, impl, None, "run", dev, torch, np, core,
                           kern, fallback=True)
        gc.collect()
        tag = f"cluster/fallback/{impl}"
        check(r["stats"]["copies"] > 0, f"{tag}: no one-copy fallback")
        check(r["stats"]["grants"] == 0, f"{tag}: a zero-copy grant was made")
        check(r["counters"]["cross_worker_copied"]
              == r["stats"]["copied_tokens"] > 0,
              f"{tag}: copied tokens not counted")
        res[impl], wires[impl] = r, w
    check(same_wires(wires["fused-round"], wires["host"], np),
          "cluster/fallback: wire bytes differ from the host run")
    for k in ("counters", "verdicts", "stats"):
        check(res["fused-round"][k] == res["host"][k],
              f"cluster/fallback: {k} differ from the host run")
    return res


def cluster_dead_owner(size: Size, dev, torch, np, core, kern):
    """Directed case (b): worker 0 takes a message in by a ``fused-round``
    round (its rows are then truth on the card), grants it to worker 1
    and is killed: the grant is copied out of the dying pool and still
    transmits, byte for byte."""
    cl = core.LibraCluster(2, n_shards=size.n_shards,
                           pages_per_shard=size.pages_per_shard,
                           page_size=size.page, secret=b"chip-smoke",
                           device=dev)
    w0, w1 = cl.workers
    crt = core.ClusterRuntime(cl)
    src = cl.socket(worker=0)
    dst = cl.socket(worker=1)
    rng = np.random.default_rng(7)
    payload = rng.integers(1000, 2000, size.payload_hi)
    src.deliver(core.build_message(rng.integers(100, 200,
                                                size.meta_app(None)),
                                   payload))
    kern.reset_launches()
    got = w0.recv_batch([src], impl="fused-round")
    torch.cuda.synchronize()
    launches = dict(kern.LAUNCHES)
    check(len(got) == 1 and launches["fused_round"] == 1,
          f"cluster/dead_owner: the fused round did not take the message "
          f"in ({launches})")
    (buf, _n), = got.values()
    dirty = len(w0.pool.dirty_rows())
    check(dirty > 0, "cluster/dead_owner: no row is truth on the card")
    vpi = next(iter(src.connection.anchored))
    granted = cl.grant_into(w1, vpi)
    check(granted is not None, "cluster/dead_owner: the grant failed")
    d2h = w0.pool.xfer["d2h_tokens"]
    info = crt.kill_worker(0)
    d2h = w0.pool.xfer["d2h_tokens"] - d2h
    out = buf.copy()
    out[-1] = core.VpiRegistry.to_token(granted)
    dst.send(out)
    wire = np.asarray(dst.tx_wire())
    check(np.array_equal(wire[-len(payload):], payload),
          "cluster/dead_owner: the copied-out payload differs")
    check(info["grants_copied_out"] == 1
          and cl.stats["dead_grants_copied"] == 1,
          f"cluster/dead_owner: {info}, {cl.stats}")
    check(w0.alloc.free_pages == w0.alloc.total_pages
          and w0.alloc.granted_out_pages == 0,
          "cluster/dead_owner: the dead pool is not fully free")
    check(d2h >= len(payload), f"cluster/dead_owner: {d2h} tokens came "
          "down, fewer than the payload")
    res = dict(payload_tokens=len(payload), dirty_rows=dirty,
               copy_out_d2h_tokens=d2h, info=info,
               dead_grants_copied=cl.stats["dead_grants_copied"],
               launches=launches)
    crt.shutdown()
    return res


def cluster_chaos(dev, torch, np, kern):
    """Directed case (c): the standard chaos scenario of
    ``scripts/check_failover_recovery_torch.py`` (reset at 25 %, kill at
    50 %, policy swap at 75 % of the fault-free run's rounds) as
    ``fused-round`` rounds on the card, under ``run()`` and under
    ``run_parallel(threads=True)`` in epochs of one round."""
    path = ROOT / "scripts" / "check_failover_recovery_torch.py"
    spec = importlib.util.spec_from_file_location("failover_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    size = dict(n_chans=9, n_msgs=12, payload=32)
    res = {}
    for threads in (False, True):
        kw = dict(size, device=dev, batch_impl="fused-round",
                  threads=threads)
        tag = f"cluster/chaos/{'threads' if threads else 'run'}"
        steady = mod.run_scenario(chaos=False, **kw)
        kern.reset_launches()
        chaos = mod.run_scenario(chaos=True, steady_rounds=steady["rounds"],
                                 **kw)
        torch.cuda.synchronize()
        launches = dict(kern.LAUNCHES)
        mod.check_identity(chaos, steady)
        mod.check_recovery(chaos, size["n_chans"], size["n_msgs"],
                           threads=threads)
        check_device_plane(tag, "fused-round", chaos["xfer"],
                           {"device_fallbacks":
                            sum(chaos["device_fallbacks"])},
                           launches, range(3))
        res["threads" if threads else "run"] = {
            "steady_rounds": steady["rounds"], "rounds": chaos["rounds"],
            "msgs": chaos["msgs"], "drops": chaos["drops"],
            "retries": chaos["retries"], "failovers": chaos["failovers"],
            "policy_failovers": chaos["policy_failovers"],
            "breaker": chaos["health"],
            "seconds": chaos["dt"], "steady_seconds": steady["dt"],
            "worker_seconds": chaos["worker_s"],
            "cluster_stats": chaos["cluster_stats"],
            "fault_hits": chaos["fault_summary"]["hits_by_kind"],
            "launches": launches}
        gc.collect()
    return res


def cluster(size: Size, dev, torch, np, core, kern):
    """Phase 10: the four-worker cluster on the card (see the module
    docstring)."""
    t0 = time.perf_counter()
    keep = ("rounds", "worker_rounds", "seconds", "resident_init_seconds",
            "rounds_per_s", "msgs", "msgs_per_s", "worker_seconds",
            "launches", "stats")
    runs = {}
    for tls, plan in ((None, (("fused-round", "run"), ("auto", "run"),
                              ("host", "run"), ("fused-round", "threads"),
                              ("host", "threads"))),
                      ("hw", (("fused-round", "run"), ("host", "run")))):
        got = cluster_identity(size, tls, plan, dev, torch, np, core, kern)
        runs[tls or "plaintext"] = {f"{r['impl']}/{r['executor']}":
                                    {k: r[k] for k in keep} for r in got}
        runs[tls or "plaintext"]["rule_hits"] = got[0]["verdicts"][
            "rule_hits"]
    fb = cluster_fallback(size, dev, torch, np, core, kern)
    dead = cluster_dead_owner(size, dev, torch, np, core, kern)
    chaos = cluster_chaos(dev, torch, np, kern)
    emit({"phase": "cluster", "workers": CLUSTER_WORKERS,
          "cross_channels": CROSS_CHANNELS, "identical": True, "runs": runs,
          "fallback": {k: {kk: v[kk] for kk in keep}
                       for k, v in fb.items()},
          "dead_owner": dead, "chaos": chaos,
          "seconds": time.perf_counter() - t0})
    return runs


# ---------------------------------------------------------------------------
# phases 5-6: attention parity and serving
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 11: the fused round's ring depth
# ---------------------------------------------------------------------------

#: rows of a round: the datapath cell's, and the N = 256 point of
#: benchmarks/bench_batched_datapath.py (its N in {8, 64, 256})
PROFILE_ROWS = {"cell": 64, "bench_n256": 256}
PROFILE_ITERS = 20
#: the depth the override pins
OVERRIDE_DEPTH = 4


def depth_profiles(size: Size, dev, dp, kern) -> dict:
    """``profile_fused_depths`` at each of :data:`PROFILE_ROWS` (page,
    pages a row and metadata as the deployment's), plaintext and with
    both keystreams: each depth's ring, best wall-clock round and best
    CUDA-event kernel time; ``dma_compute_profile`` at the picked depth;
    and ``auto_buffer_depth``'s pick from each sweep."""
    out = {}
    for label, b in PROFILE_ROWS.items():
        shape = dict(b=b, page=size.page, pps=size.pps,
                     meta_max=size.meta_max)
        row = dict(shape, tasks=b * (1 + size.pps * -(-size.page
                                                       // kern.TILE)))
        for variant, ks in (("plain", False), ("keystreams", True)):
            profs = dp.profile_fused_depths(
                depths=PROFILE_DEPTHS, iters=PROFILE_ITERS, warmup=3,
                impl="cuda", device=dev, keystreams=ks, **shape)
            pick = dp.auto_buffer_depth(profiles=profs)
            check(all(p.kernel_s is not None for p in profs.values()),
                  f"depth/{label}/{variant}: no kernel time")
            row[variant] = {
                "pick": pick,
                "depths": {d: {"ring_depth": p.ring_depth,
                               "round_us": p.round_s * 1e6,
                               "kernel_us": p.kernel_s * 1e6}
                           for d, p in profs.items()},
                "dma_compute": dp.dma_compute_profile(
                    iters=PROFILE_ITERS, warmup=3, n_buffers=pick,
                    impl="cuda", device=dev, keystreams=ks, **shape)}
        out[label] = row
    return out


def depth_runs(size: Size, tls, depths, dev, torch, np, core, kern):
    """The ``fused-round`` run of phase 2 (or 3) at each of ``depths``
    (``fused_buffers``), beside ``host``: wire bytes, counters and
    verdicts equal to ``host`` and to the default depth's run, ``xfer``
    equal to the default depth's, and every ``fused_round`` launch at the
    ring depth ``fused_buffers`` names."""
    from repro_torch.kernels.selective_copy import ring_depth

    host, host_w = e2e_run(size, "host", tls, dev, torch, np, core, kern)
    out = []
    base = base_w = None
    for fb in depths:
        r, w = e2e_run(size, "fused-round", tls, dev, torch, np, core, kern,
                       fused_buffers=fb)
        gc.collect()
        tag = f"depth/{tls or 'plaintext'}/fused_buffers={fb}"
        for ref, ref_w, what in ((host, host_w, "host"),
                                 (base, base_w, "the default depth")):
            if ref is None:
                continue
            check(same_wires(w, ref_w, np), f"{tag}: wire bytes differ "
                  f"from {what}")
            for k in ("counters", "verdicts", "msgs"):
                check(r[k] == ref[k], f"{tag}: {k} differ from {what}")
        if base is None:
            base, base_w = r, w
        check(r["xfer"] == base["xfer"], f"{tag}: xfer differs from the "
              "default depth's")
        check_device_plane(tag, "fused-round", [r["xfer"]], r["counters"],
                           r["launches"], (0,))
        n = r["launches"]["fused_round"]
        check(r["fused_depths"] == {ring_depth(fb): n},
              f"{tag}: launched at ring depths {r['fused_depths']}, "
              f"expected {n} at {ring_depth(fb)}")
        out.append({"fused_buffers": fb, "ring_depth": ring_depth(fb),
                    "rounds": r["rounds"], "seconds": r["seconds"],
                    "launches": r["launches"],
                    "fused_depths": r["fused_depths"]})
    return out


def depth(size: Size, dev, torch, np, core, kern):
    """Phase 11: profile the depths, then run the main path at the depth
    ``auto_buffer_depth`` picks at the N = 256 shape and at the depth the
    ``LIBRA_FUSED_BUFFERS`` override pins, against the default depth and
    ``host``."""
    from repro_torch.kernels import dma_profile as dp

    saved = os.environ.pop("LIBRA_FUSED_BUFFERS", None)
    try:
        profiles = depth_profiles(size, dev, dp, kern)
        pick = profiles["bench_n256"]["keystreams"]["pick"]
        os.environ["LIBRA_FUSED_BUFFERS"] = str(OVERRIDE_DEPTH)
        override = dp.auto_buffer_depth()
        check(override == OVERRIDE_DEPTH, f"LIBRA_FUSED_BUFFERS="
              f"{OVERRIDE_DEPTH}: auto_buffer_depth returned {override}")
        del os.environ["LIBRA_FUSED_BUFFERS"]
        runs = {tls or "plaintext": depth_runs(size, tls,
                                               (0, pick, override), dev,
                                               torch, np, core, kern)
                for tls in (None, "hw")}
    finally:
        os.environ.pop("LIBRA_FUSED_BUFFERS", None)
        if saved is not None:
            os.environ["LIBRA_FUSED_BUFFERS"] = saved
    emit({"phase": "depth", "identical": True, "card": card_line(torch),
          "iters": PROFILE_ITERS, "profiles": profiles, "pick": pick,
          "override": override, "runs": runs})
    return runs


def paged_case(gen, dev, torch, *, b, hq, hkv, hd, page, pps, pool_pages,
               seq_lens, gaps=False):
    """(q, pool, tables, page_pos, seq_lens) for paged_attention: row i
    owns distinct pages covering ``seq_lens[i] + 1`` keys, in order;
    ``gaps`` turns every third slot into ``-1`` and adds, after a row's
    last page, a page whose keys all lie past its ``seq_len``."""
    q = torch.randn((b, hq, hd), generator=gen, device=dev)
    pool = torch.randn((pool_pages, page, 2, hkv, hd), generator=gen,
                       device=dev)
    tables = torch.full((b, pps), -1, dtype=torch.int32)
    page_pos = torch.full((b, pps), -(1 << 20), dtype=torch.int32)
    nxt = 0
    for i, sl in enumerate(seq_lens):
        n = sl // page + 1
        for j in range(n):
            tables[i, j] = nxt % pool_pages
            page_pos[i, j] = j * page
            nxt += 1
        if gaps:
            tables[i, 1:n:3] = -1
            if n < pps:
                tables[i, n] = nxt % pool_pages
                page_pos[i, n] = (sl // page + 2) * page
                nxt += 1
    return (q, pool, tables.to(dev), page_pos.to(dev),
            torch.tensor(seq_lens, dtype=torch.int32, device=dev))


def serve_paged_case(ss: ServeSize, cfg, gen, dev, torch):
    """The decode step of a full wave: q [max_batch, Hq, hd] over one
    layer's pool view at ``timing_context`` keys per row."""
    return paged_case(gen, dev, torch, b=ss.max_batch, hq=cfg.num_heads,
                      hkv=cfg.num_kv_heads, hd=cfg.head_dim, page=ss.page,
                      pps=ss.pps, pool_pages=ss.pool_pages,
                      seq_lens=[ss.timing_context] * ss.max_batch)


def paged_timing_case(ss: ServeSize, cfg, gen, dev, torch):
    """Inputs of one layer's decode attention of a full wave, its label,
    the function's operations and bytes: 4 hd multiply-add operations per
    (query head, valid key); q, the valid keys' K and V head rows, the
    table, positions and lengths read once, the partial (acc, m, l)
    written once."""
    pc = serve_paged_case(ss, cfg, gen, dev, torch)
    q, _pool, tables, page_pos, sl = pc
    pos = (page_pos[:, :, None].long()
           + torch.arange(ss.page, device=dev)[None, None, :])
    keys = int(((tables[:, :, None] >= 0) & (pos <= sl.long()[:, None, None]))
               .sum())
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    reads = q.numel() + keys * 2 * hkv * hd + 2 * tables.numel() + sl.numel()
    writes = q.numel() + 2 * q.shape[0] * hq
    return (pc, f"B={q.shape[0]} ctx={ss.timing_context}",
            4 * hq * hd * keys, 4 * (reads + writes))


def flash_case(gen, dev, torch, *, b, hq, hkv, s, hd):
    return (torch.randn((b, hq, s, hd), generator=gen, device=dev),
            torch.randn((b, hkv, s, hd), generator=gen, device=dev),
            torch.randn((b, hkv, s, hd), generator=gen, device=dev))


ATTN_KERNELS = ("paged_attention", "flash_attention")


def attn_parity(ss: ServeSize, cfg, dev, torch, ops, kernels=ATTN_KERNELS):
    """The attention ``kernels`` against their plain versions on the
    card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    results = []

    def record(kernel, label, outs_k, outs_r):
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(outs_k, outs_r))
        ok = all(torch.allclose(a, b, **ATTN_TOL)
                 for a, b in zip(outs_k, outs_r))
        results.append(dict(kernel=kernel, case=label, close=ok,
                            max_abs_err=err,
                            max_abs_ref=max(float(b.abs().max())
                                            for b in outs_r)))
        check(ok, f"{kernel} [{label}] differs from its plain version "
                  f"(max abs err {err})")

    full = dict(b=ss.max_batch, hq=cfg.num_heads, hkv=cfg.num_kv_heads,
                s=ss.prompt, hd=cfg.head_dim)
    flash = [("g1-hd64", dict(b=2, hq=4, hkv=4, s=256, hd=64), True, 0),
             ("g3-hd128-tail", dict(b=2, hq=6, hkv=2, s=200, hd=128), True,
              0),
             ("g3-hd64-window", dict(b=1, hq=6, hkv=2, s=300, hd=64), True,
              100),
             ("g1-hd128-noncausal", dict(b=1, hq=2, hkv=2, s=130, hd=128),
              False, 0),
             ("g2-hd16-tail", dict(b=2, hq=4, hkv=2, s=40, hd=16), True, 0),
             ("g3-hd96-tail", dict(b=1, hq=3, hkv=1, s=70, hd=96), True, 0),
             ("g3-hd96-window-tail", dict(b=2, hq=6, hkv=2, s=390, hd=96),
              True, 130),
             ("g4-hd32-noncausal-window", dict(b=1, hq=8, hkv=2, s=270,
                                               hd=32), False, 75),
             ("serve", full, True, 0)]
    if "flash_attention" not in kernels:
        flash = []
    for label, shape, causal, window in flash:
        q, k, v = flash_case(gen, dev, torch, **shape)
        outs = [ops.flash_attention(q, k, v, causal=causal, window=window,
                                    impl=impl) for impl in ("cuda", "ref")]
        record("flash_attention", label, outs[:1], outs[1:])
    paged = [("g1-hd64", dict(b=4, hq=8, hkv=8, hd=64, page=16, pps=8,
                              pool_pages=40, seq_lens=[5, 60, 100, 127]),
              False, 0),
             ("g3-hd128-gaps-window", dict(b=3, hq=6, hkv=2, hd=128, page=16,
                                           pps=10, pool_pages=40,
                                           seq_lens=[33, 120, 0]), True, 40),
             ("g3-hd128-gaps", dict(b=3, hq=6, hkv=2, hd=128, page=16,
                                    pps=10, pool_pages=40,
                                    seq_lens=[33, 120, 0]), True, 0),
             ("g2-hd16", dict(b=2, hq=4, hkv=2, hd=16, page=8, pps=5,
                              pool_pages=12, seq_lens=[17, 30]), False, 0),
             ("g4-hd96-gaps", dict(b=3, hq=8, hkv=2, hd=96, page=16, pps=12,
                                   pool_pages=40, seq_lens=[100, 17, 150]),
              True, 0),
             ("g1-hd32-pps70", dict(b=2, hq=4, hkv=4, hd=32, page=16, pps=70,
                                    pool_pages=120,
                                    seq_lens=[1000, 555]), False, 0),
             ("g8-hd64-page32-gaps-window",
              dict(b=2, hq=16, hkv=2, hd=64, page=32, pps=10, pool_pages=24,
                   seq_lens=[200, 70]), True, 150),
             ("g12-hd16", dict(b=2, hq=12, hkv=1, hd=16, page=8, pps=9,
                               pool_pages=20, seq_lens=[40, 63]), False, 0),
             ("b1-ctx1040", dict(b=1, hq=cfg.num_heads, hkv=cfg.num_kv_heads,
                                 hd=cfg.head_dim, page=ss.page, pps=ss.pps,
                                 pool_pages=ss.pool_pages,
                                 seq_lens=[ss.timing_context]), False, 0)]
    if "paged_attention" in kernels:
        for label, shape, gaps, window in paged:
            case = paged_case(gen, dev, torch, gaps=gaps, **shape)
            outs = [ops.paged_attention(*case, window=window, impl=impl)
                    for impl in ("cuda", "ref")]
            record("paged_attention", label, outs[0], outs[1])
        case = serve_paged_case(ss, cfg, gen, dev, torch)
        outs = [ops.paged_attention(*case, impl=impl)
                for impl in ("cuda", "ref")]
        record("paged_attention", "serve", outs[0], outs[1])
    emit({"phase": "attn_parity", "cases": len(results),
          "all_close": all(r["close"] for r in results), "tol": ATTN_TOL,
          "max_abs_err": {k: max(r["max_abs_err"] for r in results
                                 if r["kernel"] == k)
                          for k in kernels},
          "by_case": {f'{r["kernel"]}/{r["case"]}': [r["max_abs_err"],
                                                      r["max_abs_ref"]]
                      for r in results}})
    return results


class LogitMargins:
    """Top-2 margin and spread (max - min) of every row of every logits
    call of one run and, for an engine run (:meth:`step`), which call and
    row produced each token."""

    def __init__(self, model):
        self.calls = []           # [(margins [rows], spreads [rows])]
        self.where = {}           # (rid, token index) -> (call, row)
        inner = model.logits

        def logits(params, hidden):
            out = inner(params, hidden)
            top = out.topk(2, dim=-1).values
            self.calls.append(((top[:, 0] - top[:, 1]).tolist(),
                               (out.amax(-1) - out.amin(-1)).tolist()))
            return out
        model.logits = logits

    def step(self, eng, reqs):
        """``eng.step()``, noting where each new token came from: the
        prefill call (rows in admission order), then the decode call (rows
        are slots)."""
        waiting = list(eng.waiting)
        lens = {r.rid: len(r.output) for r in reqs}
        first = len(self.calls)
        eng.step()
        still = {r.rid for r in eng.waiting}
        admitted = [r.rid for r in waiting if r.rid not in still]
        for row, rid in enumerate(admitted):
            self.where[(rid, 0)] = (first, row)
        decode = first + (1 if admitted else 0)
        if len(self.calls) > decode:
            for r in reqs:
                had = lens[r.rid] + (1 if r.rid in admitted else 0)
                if len(r.output) > had:
                    self.where[(r.rid, had)] = (decode, r.slot)

    def margin(self, rid, index):
        call, row = self.where[(rid, index)]
        margins, spreads = self.calls[call]
        return margins[row], spreads[row]


def serve_run(ss: ServeSize, model, params, prompts, dev, torch, kattn,
              margins=None):
    """One engine run over ``prompts``; returns (engine, results)."""
    from repro_torch.core.parser import TokenStreamParser
    from repro_torch.serving.engine import LibraEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = LibraEngine(model, params, max_batch=ss.max_batch,
                      max_len=ss.max_len, page_size=ss.page,
                      parser=TokenStreamParser(header_len=ss.header),
                      device=dev)
    check(eng.pool.alloc.total_pages == ss.pool_pages and eng.pps == ss.pps,
          "engine geometry differs from the serve size")
    reqs = [eng.submit(p, max_new_tokens=ss.gen) for p in prompts]
    kattn.reset_launches()
    step_s = {"prefill": [], "decode": []}   # a step ends on a token download
    t0 = time.perf_counter()
    while eng.waiting or eng.active:
        prefills = eng.stats.prefills
        ts = time.perf_counter()
        if margins is None:
            eng.step()
        else:
            margins.step(eng, reqs)
        step_s["prefill" if eng.stats.prefills > prefills else "decode"
               ].append(time.perf_counter() - ts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kattn.LAUNCHES)
    alloc = eng.pool.alloc
    check(alloc.free_pages == alloc.total_pages - 1 and
          len(eng.pool.registry) == 0,
          f"{model.attn_impl}: pages leaked ({alloc.free_pages} of "
          f"{alloc.total_pages} free, the parking page held)")
    ttft = sorted(r.first_token_at - r.submitted_at for r in reqs)
    out = dict(attn_impl=model.attn_impl, seconds=dt,
               tokens=eng.throughput_tokens(),
               tokens_per_s=eng.throughput_tokens() / dt,
               p99_latency_ms=eng.p99_latency() * 1e3,
               ttft_s={"first": ttft[0], "median": statistics.median(ttft),
                       "last": ttft[-1]},
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               prefill_step_s=step_s["prefill"],
               decode_step_ms={k: f(step_s["decode"]) * 1e3 for k, f in (
                   ("min", min), ("median", statistics.median),
                   ("max", max))},
               launches=launches, steps=eng.stats.steps,
               stats=dataclasses.asdict(eng.stats),
               counters=dataclasses.asdict(eng.stack.counters),
               outputs={r.rid: list(r.output) for r in reqs})
    return eng, out


def decode_split(eng, prompts, ss: ServeSize, torch):
    """Profiler split of one decode step of a full batch: device time of
    matmuls, the attention kernel, the KV write and everything else, and
    the host gaps (wall minus device time; one stream, no overlap)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    for p in prompts[:ss.max_batch]:
        eng.submit(p, max_new_tokens=3)
    eng.step()                                 # prefill + first decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()                             # a decode step, nothing else
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run()
    kinds = {"attention": re.compile(r"paged_attention"),
             "matmul": re.compile(r"gemm|gemv|xmma|cutlass|splitK|dot_kernel",
                                  re.I),
             "kv_write": re.compile(r"index_put"),
             "copies": re.compile(r"memcpy|memset", re.I)}
    split = {k: 0.0 for k in (*kinds, "other")}
    top = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = e.device_time_total
        kind = next((k for k, rx in kinds.items() if rx.search(e.key)),
                    "other")
        split[kind] += us / 1e3
        top[e.key[:70]] = us / 1e3
    device_ms = sum(split.values())
    check(split["attention"] > 0, "the profiled step ran no paged_attention")
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "host_gap_ms": wall * 1e3 - device_ms,
            "device_busy_share": device_ms / (wall * 1e3),
            "device_ms_by_kind": split,
            "top_device_ms": dict(sorted(top.items(),
                                         key=lambda kv: -kv[1])[:10])}


def serve(ss: ServeSize, dev, torch, np, kattn):
    """phi4-mini-3.8b under LibraEngine, kernels against plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config(ss.arch)
    models = {impl: build_model(cfg, page_size=ss.page, attn_impl=impl)
              for impl in ("auto", "ref")}
    t0 = time.perf_counter()
    params = models["auto"].init_params(ss.seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(ss.seed)
    prompts = [rng.integers(1, cfg.vocab_size - 1, ss.prompt)
               for _ in range(ss.requests)]
    margins = LogitMargins(models["ref"])
    eng, kern_run = serve_run(ss, models["auto"], params, prompts, dev,
                              torch, kattn)
    split = decode_split(eng, prompts, ss, torch)
    del eng
    _eng, ref_run = serve_run(ss, models["ref"], params, prompts, dev, torch,
                              kattn, margins)
    del _eng
    check(kern_run["stats"] == ref_run["stats"],
          "EngineStats differ between the kernel and plain runs")
    check(kern_run["counters"] == ref_run["counters"],
          "CopyCounters differ between the kernel and plain runs")
    diverged = []
    for rid, want in ref_run["outputs"].items():
        got = kern_run["outputs"][rid]
        check(len(got) == len(want) == ss.gen, f"request {rid}: wrong length")
        first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                     None)
        if first is None:
            continue
        m, spread = margins.margin(rid, first)
        diverged.append(dict(rid=rid, token=first, margin=m, spread=spread))
        check(m < 1e-3 * spread,
              f"request {rid} token {first}: kernel {got[first]} vs plain "
              f"{want[first]}, plain top-2 margin {m} is not below 1e-3 of "
              f"the spread {spread}")
    for name in kattn.LAUNCHES:
        check(kern_run["launches"][name] > 0,
              f"{name} never launched in the serve run")
        check(ref_run["launches"][name] == 0,
              f"{name} launched in the plain run")
    keep = ("seconds", "tokens", "tokens_per_s", "p99_latency_ms", "ttft_s",
            "peak_mem_gb", "prefill_step_s", "decode_step_ms",
            "launches", "steps")
    emit({"phase": "serve", "arch": ss.arch, "params": cfg.param_count(),
          "param_init_s": init_s, "requests": ss.requests,
          "prompt": ss.prompt, "gen": ss.gen, "max_batch": ss.max_batch,
          "page": ss.page, "pool_pages": ss.pool_pages,
          "identical_tokens": not diverged, "diverged": diverged,
          "stats": kern_run["stats"], "counters": kern_run["counters"],
          "kernels": {k: kern_run[k] for k in keep},
          "plain": {k: ref_run[k] for k in keep},
          "decode_step_split": split})
    del params
    torch.cuda.empty_cache()
    return kern_run


# ---------------------------------------------------------------------------
# phases 7-8: mLSTM parity and the xLSTM run
# ---------------------------------------------------------------------------

def mlstm_case(gen, dev, torch, *, b, h, s, dh, extreme=False):
    """q, k, v [B, H, S, dh] ~ N(0, 1); log_i ~ N(0, 1) and log_f =
    logsigmoid(N(2, 1)), as the JAX package's tests draw them; ``extreme``
    draws log_i ~ N(0, 16) and log_f = logsigmoid(N(0, 16))."""
    F = torch.nn.functional

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    q, k, v = rn(b, h, s, dh), rn(b, h, s, dh), rn(b, h, s, dh)
    if extreme:
        return q, k, v, rn(b, h, s) * 4, F.logsigmoid(rn(b, h, s) * 4)
    return q, k, v, rn(b, h, s), F.logsigmoid(rn(b, h, s) + 2)


def mlstm_parity(xs: XlstmSize, cfg, dev, torch, ops):
    """The mLSTM kernel against the plain chunked version on the card: h
    and the final (C, n, m)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    dh_run = cfg.ssm_expand * cfg.d_model // cfg.num_heads
    run = dict(b=xs.batch, h=cfg.num_heads, s=xs.prompt, dh=dh_run)
    # (label, shape, chunk, extreme): tests/test_kernels.py's shapes, its
    # gate extremes, ragged S, the (dh, chunk) pairs those leave out, and
    # the run's shape
    cases = [("b1h1-s64-dh32-c16", dict(b=1, h=1, s=64, dh=32), 16, False),
             ("b2h3-s64-dh32-c32", dict(b=2, h=3, s=64, dh=32), 32, False),
             ("b1h2-s128-dh64-c16", dict(b=1, h=2, s=128, dh=64), 16, False),
             ("extreme-b2h2-s64-dh16-c16", dict(b=2, h=2, s=64, dh=16), 16,
              True),
             ("extreme-b1h2-s64-dh16-c32", dict(b=1, h=2, s=64, dh=16), 32,
              True),
             ("ragged-b2h3-s100-dh32-c32", dict(b=2, h=3, s=100, dh=32), 32,
              False),
             ("ragged-b2h2-s70-dh64-c64", dict(b=2, h=2, s=70, dh=64), 64,
              False),
             ("ragged-b1h4-s1000-dh512-c64", dict(b=1, h=4, s=1000,
                                                  dh=dh_run), 64, False),
             ("b2h2-s192-dh16-c64", dict(b=2, h=2, s=192, dh=16), 64, False),
             ("ragged-b1h3-s160-dh32-c64", dict(b=1, h=3, s=160, dh=32), 64,
              False),
             ("b2h1-s96-dh64-c32", dict(b=2, h=1, s=96, dh=64), 32, False),
             ("ragged-b1h2-s300-dh512-c16", dict(b=1, h=2, s=300,
                                                 dh=dh_run), 16, False),
             ("b2h2-s256-dh512-c32", dict(b=2, h=2, s=256, dh=dh_run), 32,
              False),
             ("run", run, xs.chunk, False)]
    results = []
    for label, shape, chunk, extreme in cases:
        case = mlstm_case(gen, dev, torch, extreme=extreme, **shape)
        outs = [ops.mlstm_scan(*case, chunk=chunk, impl=impl,
                               return_state=True) for impl in ("cuda", "ref")]
        torch.cuda.synchronize()
        (hk, sk), (hr, sr) = outs
        tol = MLSTM_TOL_EXTREME if extreme else MLSTM_TOL
        pairs = dict(zip(("h", "C", "n", "m"), zip((hk, *sk), (hr, *sr))))
        errs = {k: float((a - b).abs().max()) for k, (a, b) in pairs.items()}
        ok = all(torch.isfinite(a).all() and torch.allclose(a, b, **tol)
                 for a, b in pairs.values())
        results.append(dict(kernel="mlstm_scan", case=label, close=bool(ok),
                            dh=shape["dh"], chunk=chunk,
                            tol=tol, max_abs_err=max(errs.values()),
                            max_abs_err_by_output=errs))
        if label == "run":  # both against the plain version in float64
            h64, s64 = ops.mlstm_scan(*(x.double() for x in case),
                                      chunk=chunk, impl="ref",
                                      return_state=True)
            results[-1]["vs_f64"] = {
                who: {k: float((a.double() - b).abs().max())
                      for k, a, b in zip(("h", "C"), (hh, st[0]),
                                         (h64, s64[0]))}
                for who, hh, st in (("kernel", hk, sk), ("plain", hr, sr))}
            del h64, s64
        check(ok, f"mlstm_scan [{label}] differs from its plain version "
                  f"(max abs errors {errs}, tolerance {tol})")
    pairs = {(r["dh"], r["chunk"]) for r in results}
    check(len(pairs) == 12, f"mlstm_parity reaches {len(pairs)} of the 12 "
                            "(dh, chunk) instantiations")
    emit({"phase": "mlstm_parity", "cases": len(results),
          "instantiations": len(pairs),
          "all_close": all(r["close"] for r in results),
          "tol": MLSTM_TOL, "tol_gate_extremes": MLSTM_TOL_EXTREME,
          "max_abs_err": {r["case"]: r["max_abs_err_by_output"]
                          for r in results},
          "run_vs_f64": results[-1]["vs_f64"]})
    return results


def xlstm_run(xs: XlstmSize, model, params, tokens, seq_lens, torch,
              kmlstm):
    """One prefill and ``gen - 1`` greedy decode steps; returns the run's
    numbers, its tokens and a copy of the decode state after prefill."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kmlstm.reset_launches()
    t0 = time.perf_counter()
    first, state = model.prefill(params, tokens, seq_lens)
    out = [first.tolist()]                 # the step ends on a download
    prefill_s = time.perf_counter() - t0
    after_prefill = {k: v.clone() for k, v in state.items()}
    cur, step_s = first, []
    for i in range(xs.gen - 1):
        ts = time.perf_counter()
        cur, state = model.decode_step(params, cur, seq_lens + i, state)
        out.append(cur.tolist())
        step_s.append(time.perf_counter() - ts)
    torch.cuda.synchronize()
    total = prefill_s + sum(step_s)
    finite = all(bool(torch.isfinite(v).all()) for v in state.values())
    check(finite, f"{model.mlstm_impl}: non-finite decode state")
    run = dict(mlstm_impl=model.mlstm_impl, prefill_s=prefill_s,
               prefill_tokens_per_s=xs.batch * xs.prompt / prefill_s,
               decode_step_ms={k: f(step_s) * 1e3 for k, f in (
                   ("min", min), ("median", statistics.median),
                   ("max", max))},
               decode_tokens_per_s=xs.batch * len(step_s) / sum(step_s),
               seconds=total, tokens_per_s=xs.batch * xs.gen / total,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=dict(kmlstm.LAUNCHES))
    rows = [list(r) for r in zip(*out)]    # [batch][gen]
    return run, rows, after_prefill


def prefill_split(model, params, tokens, seq_lens, torch):
    """One profiled prefill: device time by kernel kind, and the host wall
    of the mLSTM scans (transposes in, scan; synchronised) and of the
    sLSTM step loops; host gaps are wall minus device time. Only device
    activity is traced, and the raw trace events are summed: the 3 x 4096
    sLSTM steps launch about 250 000 kernels, too many to turn into
    ``key_averages``' per-op events within the script's time."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import ssm

    wall = {"mlstm_scan_calls": 0.0, "slstm_step_loops": 0.0}

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            wall[key] += time.perf_counter() - t
            return out
        return run
    scan, loop = ssm.ops.mlstm_scan, ssm._slstm_scan
    ssm.ops.mlstm_scan = timed("mlstm_scan_calls", scan)
    ssm._slstm_scan = timed("slstm_step_loops", loop)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.prefill(params, tokens, seq_lens)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        ssm.ops.mlstm_scan, ssm._slstm_scan = scan, loop
    kinds = {"mlstm_scan": re.compile(r"mlstm_scan"),
             "matmul": re.compile(r"gemm|gemv|xmma|cutlass|splitK|dot_kernel",
                                  re.I),
             "copies": re.compile(r"copy|memcpy|memset", re.I)}
    split = {k: 0.0 for k in (*kinds, "other")}
    top, n_events = {}, 0
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        n_events += 1
        ms = e.duration_ns() / 1e6
        kind = next((k for k, rx in kinds.items() if rx.search(e.name())),
                    "other")
        split[kind] += ms
        top[e.name()[:70]] = top.get(e.name()[:70], 0.0) + ms
    device_ms = sum(split.values())
    check(split["mlstm_scan"] > 0, "the profiled prefill ran no mlstm_scan")
    return {"wall_s": wall_s, "device_s": device_ms / 1e3,
            "host_gap_s": wall_s - device_ms / 1e3,
            "device_busy_share": device_ms / 1e3 / wall_s,
            "device_events": n_events,
            "device_ms_by_kind": split,
            "host_wall_s_synchronised": wall,
            "top_device_ms": dict(sorted(top.items(),
                                         key=lambda kv: -kv[1])[:10])}


def scan_state(model, params, tokens, seq_lens, torch, dtype):
    """The decode state after a prefill whose mLSTM scans run the plain
    chunked version on inputs cast to ``dtype`` (everything else as in the
    plain run). float64 gives the yardstick both float32 runs are measured
    against; bfloat16 (inputs rounded, computed in float32) gives the
    control the state rule must flag."""
    from repro_torch.models import ssm

    scan = ssm.ops.mlstm_scan

    def cast(q, k, v, log_i, log_f, *, chunk, impl, return_state):
        h, st = scan(*(t.to(dtype) for t in (q, k, v, log_i, log_f)),
                     chunk=chunk, impl="ref", return_state=True)
        return h.float(), tuple(t.float() for t in st)
    ssm.ops.mlstm_scan = cast
    try:
        return model.prefill(params, tokens, seq_lens)[1]
    finally:
        ssm.ops.mlstm_scan = scan


def xlstm_serve(xs: XlstmSize, dev, torch, np, kmlstm):
    """xlstm-350m prefill + decode, the kernel against the plain version."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = get_config(xs.arch)
    models = {impl: build_model(cfg, mlstm_impl=impl)
              for impl in ("auto", "ref")}
    t0 = time.perf_counter()
    params = models["auto"].init_params(xs.seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(xs.seed)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab_size - 1, (xs.batch, xs.prompt)).astype(np.int32)).to(dev)
    seq_lens = torch.full((xs.batch,), xs.prompt, dtype=torch.int32,
                          device=dev)
    # the plain run's logits calls: call 0 is the prefill (the first
    # tokens), call i the decode step that gave token i
    margins = LogitMargins(models["ref"])
    kern_run, kern_rows, kern_state = xlstm_run(
        xs, models["auto"], params, tokens, seq_lens, torch, kmlstm)
    split = prefill_split(models["auto"], params, tokens, seq_lens, torch)
    ref_run, ref_rows, ref_state = xlstm_run(
        xs, models["ref"], params, tokens, seq_lens, torch, kmlstm)
    y_state = scan_state(models["ref"], params, tokens, seq_lens, torch,
                         torch.float64)
    ctl_state = scan_state(models["ref"], params, tokens, seq_lens, torch,
                           torch.bfloat16)
    n_mlstm = models["auto"].n_mlstm
    # the decode state after prefill: distances to the run whose scans
    # are computed in float64, and each run's ratio to the plain run's
    state_err, far = {}, []
    for key, y in y_state.items():
        e_kern = float((kern_state[key] - y).abs().max())
        e_plain = float((ref_state[key] - y).abs().max())
        e_ctl = float((ctl_state[key] - y).abs().max())
        scale = float(y.abs().max())
        slack = 1e-6 * scale
        state_err[key] = {
            "kernel_vs_plain": float((kern_state[key] - ref_state[key])
                                     .abs().max()),
            "kernel_vs_f64": e_kern, "plain_vs_f64": e_plain,
            "bf16_control_vs_f64": e_ctl,
            "kernel_ratio": e_kern / max(e_plain, slack),
            "bf16_control_ratio": e_ctl / max(e_plain, slack),
            "max_abs": scale}
        if e_kern > XLSTM_STATE_FACTOR * e_plain + slack:
            far.append(key)
        if e_ctl > XLSTM_STATE_FACTOR * e_plain + slack:
            state_err[key]["bf16_control_flagged"] = True
    del kern_state, ref_state, y_state, ctl_state
    ratios = {r: max(e[r] for e in state_err.values())
              for r in ("kernel_ratio", "bf16_control_ratio")}
    diverged = []
    for row, (got, want) in enumerate(zip(kern_rows, ref_rows)):
        first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                     None)
        if first is not None:
            margin_rows, spread_rows = margins.calls[first]
            diverged.append(dict(row=row, token=first,
                                 kernel=got[first], plain=want[first],
                                 margin=margin_rows[row],
                                 spread=spread_rows[row]))
    emit({"phase": "xlstm_serve", "arch": xs.arch,
          "params": cfg.param_count(), "param_init_s": init_s,
          "mlstm_blocks": n_mlstm, "slstm_blocks": models["auto"].n_slstm,
          "batch": xs.batch, "prompt": xs.prompt, "gen": xs.gen,
          "identical_tokens": not diverged, "diverged": diverged,
          "state_rule": f"max |kernel - f64| <= {XLSTM_STATE_FACTOR} x "
                        "max |plain - f64| + 1e-6 x max |f64|",
          "state_after_prefill": state_err,
          "max_kernel_ratio": ratios["kernel_ratio"],
          "max_bf16_control_ratio": ratios["bf16_control_ratio"],
          "kernels": kern_run, "plain": ref_run, "prefill_split": split})
    check(kern_run["launches"]["mlstm_scan"] == n_mlstm,
          f"mlstm_scan launched {kern_run['launches']['mlstm_scan']} times "
          f"in the kernel run, expected one per mLSTM block ({n_mlstm})")
    check(ref_run["launches"]["mlstm_scan"] == 0,
          "mlstm_scan launched in the plain run")
    check(not far, f"decode state {far} after prefill: the kernel run is "
                   "farther from the float64-scan run than the rule allows")
    check(any(e.get("bf16_control_flagged") for e in state_err.values()),
          "the state rule passes the bfloat16-input control: it cannot "
          "tell a faulty scan from a sound one")
    for row, (got, want) in enumerate(zip(kern_rows, ref_rows)):
        check(len(got) == len(want) == xs.gen, f"row {row}: wrong length")
    for d in diverged:
        check(d["margin"] < 1e-3 * d["spread"],
              f"row {d['row']} token {d['token']}: kernel {d['kernel']} vs "
              f"plain {d['plain']}, plain top-2 margin {d['margin']} is not "
              f"below 1e-3 of the spread {d['spread']}")
    del params
    torch.cuda.empty_cache()
    return kern_run


# ---------------------------------------------------------------------------
# phase 9: timing
# ---------------------------------------------------------------------------

def time_ms(fn, torch, runs: int = TIMED_RUNS, clean_l2: bool = False
            ) -> float:
    """Median device time of ``fn`` in ms: CUDA events around each call,
    the 50 MB L2 flushed before it (the round's operands arrive cold). A
    spin kernel holds the stream while the host enqueues the start event,
    the call and the end event, so the host's launch overhead is not
    counted; a call that waits on the device itself (the plain versions'
    masked indexing) still counts its host gaps. The flush writes 64 MB,
    so the L2 holds dirty lines whose write-back falls inside the timed
    call; ``clean_l2`` flushes by reading 64 MB instead."""
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if clean_l2:
            flush.view(torch.float32).sum()
        else:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def anchored_tokens(ml, tl, tables, page, s, np) -> int:
    """Payload tokens the anchor writes for these inputs."""
    b, pps = tables.shape
    rel = np.arange(pps * page)[None, :]
    pid = np.repeat(tables, page, axis=1)
    pos = ml[:, None].astype(np.int64) + rel
    ok = (pid >= 0) & (rel < (tl - ml)[:, None]) & (pos >= 0) & (pos < s)
    return int(ok.sum())


def gathered_tokens(tables, lengths, page, np) -> int:
    b, pps = tables.shape
    rel = np.arange(pps * page)[None, :]
    ok = (np.repeat(tables, page, axis=1) >= 0) & (rel < lengths[:, None])
    return int(ok.sum())


def policy_refs(off, ml, m, plen, w, np) -> int:
    """Distinct metadata / window tokens the conditions read, summed over
    the messages."""
    off = off.reshape(-1)
    meta_offs = np.unique(off[off >= 0])
    pay_pos = np.unique(-off[off <= -2] - 2)
    n = 0
    for i in range(len(ml)):
        n += int(((meta_offs < ml[i]) & (meta_offs < m)).sum())
        n += int(((pay_pos < plen[i]) & (pay_pos < w)).sum())
    return n


def peak_ops_per_s(torch, per_sm_clock: int) -> float:
    """Peak operations per second of the current card for an instruction
    type that issues ``per_sm_clock`` results per SM per clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = subprocess.run(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip()
    return sms * per_sm_clock * float(mhz) * 1e6


def bound(bytes_: int, ops_: int, ops_per_s: float):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / ops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            bytes_)


def mlstm_timing_case(xs: XlstmSize, gen, dev, torch):
    """Inputs of one mLSTM block of the xLSTM prefill, its label, the
    function's operations and bytes. Per (row, head, chunk): q kT and
    (S o qk) v over the causal triangle, c(c+1)/2 dh multiply-adds each (the
    gate matrix is -1e30 above the diagonal), q C and (k w)T v, c dh^2 each;
    q, k, v, the gates read once, h and the final state written once. No
    single PyTorch call computes an mLSTM."""
    from repro_torch.configs import get_config

    xcfg = get_config(xs.arch)
    dh = xcfg.ssm_expand * xcfg.d_model // xcfg.num_heads
    mc = mlstm_case(gen, dev, torch, b=xs.batch, h=xcfg.num_heads,
                    s=xs.prompt, dh=dh)
    c, bh = xs.chunk, xs.batch * xcfg.num_heads
    chunks = -(-xs.prompt // c)
    flops = 2 * bh * chunks * (c * (c + 1) * dh + 2 * c * dh * dh)
    nbytes = 4 * (4 * mc[0].numel() + 2 * mc[3].numel()
                  + bh * (dh * dh + dh + 1))
    label = (f"B={xs.batch} H={xcfg.num_heads} S={xs.prompt} dh={dh} "
             f"chunk={c}")
    return mc, label, flops, nbytes


def flash_timing_case(ss: ServeSize, cfg, gen, dev, torch):
    """Inputs of one layer's prefill attention of a full wave, causal, its
    label, the function's operations and bytes: 4 hd multiply-add
    operations per (query head, query, key) pair of the causal triangle; q,
    k, v read once, the output written once."""
    fq, fk, fv = flash_case(gen, dev, torch, b=ss.max_batch,
                            hq=cfg.num_heads, hkv=cfg.num_kv_heads,
                            s=ss.prompt, hd=cfg.head_dim)
    pairs = ss.prompt * (ss.prompt + 1) // 2
    flops = 4 * ss.max_batch * cfg.num_heads * cfg.head_dim * pairs
    nbytes = 4 * 2 * (fq.numel() + fk.numel())
    return (fq, fk, fv), f"B={ss.max_batch} S={ss.prompt} causal", flops, \
        nbytes


def copy_timing_case(size: Size, rng, dev, np, tt):
    """The deployment's RX selective copy (64 rows, 256 metadata tokens,
    16 pages of 1024 tokens, meta_len drawn from [0, 256], anchored into
    the 128 MiB pool), the tokens it writes, and the bytes and operations
    of each variant: the payload lanes of the stream (and keystream) and
    the metadata prefixes read, the table and lengths read, the pool
    tokens and the [B, meta_max] block written."""
    case = widen(selcopy_dict(tt.selcopy_crypto_case(
        rng, b=size.channels, page=size.page, pps=size.pps,
        meta_max=size.meta_max)), size.pool_rows, rng, np)
    c = tt.to_torch(case, dev)
    ml, tl, tb = case["meta_len"], case["total_len"], case["tables"]
    b, s = case["stream"].shape
    n_pay = anchored_tokens(ml, tl, tb, size.page, s, np)
    n_meta = int(np.minimum(ml, size.meta_max).sum())
    writes = n_pay + b * size.meta_max

    def cost(crypto):
        reads = n_pay * (2 if crypto else 1) + n_meta + tb.size + 2 * b
        return 4 * (reads + writes), n_pay * (1 + crypto)
    return c, writes, cost


def policy_timing_case(size: Size, rng, dev, np, tt):
    """The deployment's policy match (64 messages, 256 metadata tokens,
    the three-rule table, a payload window of one page), and the bytes
    and operations of each variant: the tokens the conditions read (twice
    with the keystream), the table, the lengths, the verdicts."""
    meta, pml, off, lo, hi, pks, pw, pln = tt.policy_payload_case(
        rng, b=size.channels, meta_max=size.meta_max, r=3, k=1, w=size.page)
    p = tt.to_torch(dict(meta=meta, ml=pml, off=off, lo=lo, hi=hi, ks=pks,
                         pw=pw, pln=pln), dev)
    refs = policy_refs(off, pml, size.meta_max, pln, size.page, np)

    def cost(crypto):
        reads = refs * (2 if crypto else 1) + 3 * off.size + 2 * len(pml)
        return 4 * (reads + len(pml)), 3 * refs
    return p, cost


def gather_timing_case(size: Size, rng, dev, np, tt):
    """The deployment's egress gather (64 rows x 16 pages of 1024 tokens
    out of the 128 MiB pool), the index of its table rows for
    ``index_select``, and the bytes the function moves: the live pool
    tokens (and as many keystream tokens) read, the table and lengths
    read, the whole output written."""
    pool, tables, lengths, gks = tt.selgather_case(
        rng, b=size.channels, page=size.page, pps=size.pps,
        p_total=size.pool_rows - 1)
    g = tt.to_torch(dict(pool=pool, tables=tables, lengths=lengths, ks=gks),
                    dev)
    n_g = gathered_tokens(tables, lengths, size.page, np)
    rows_idx = g["tables"].reshape(-1).long().clamp(min=0)

    def nbytes(crypto):
        reads = n_g * (2 if crypto else 1) + tables.size + len(lengths)
        return 4 * (reads + tables.size * size.page)
    return g, rows_idx, n_g, nbytes


def fused_timing_case(size: Size, rng, dev, np, tt):
    """The deployment's fused round (64 rows, 16 pages of 1024 tokens,
    256 metadata tokens, the three-rule table), its operands by variant
    and the bytes and operations of each: payload lanes of the stream (and
    RX and TX keystreams) read, written once to the pool and once to the
    output, the metadata block, the tokens the conditions read, the
    tables."""
    big = dict(b=size.channels, page=size.page, pps=size.pps,
               meta_max=size.meta_max)
    page, mm = size.page, size.meta_max
    case = widen(tt.fused_round_case(rng, r=3, k=1, **big), size.pool_rows,
                 rng, np)
    f = tt.to_torch(case, dev)
    ml, tl, tb = case["meta_len"], case["total_len"], case["tables"]
    b, s = case["stream"].shape
    n_pay = anchored_tokens(ml, tl, tb, page, s, np)
    n_meta = int(np.minimum(ml, mm).sum())
    refs = policy_refs(case["cond_off"], ml, mm, tl - ml, page, np)
    variants = {}
    for crypto in (False, True):
        keys = ["cond_off", "cond_lo", "cond_hi"]
        if crypto:
            keys += ["keystream", "tx_keystream"]
        per_tok = 3 if crypto else 1        # stream (+ RX ks, + TX ks)
        reads = (n_pay * per_tok + n_meta + refs * (2 if crypto else 1)
                 + tb.size + 2 * b + 3 * case["cond_off"].size)
        writes = n_pay + b * mm + tb.size * page + b
        variants["ks+policy" if crypto else "plain+policy"] = (
            {k: f[k] for k in keys}, 4 * (reads + writes),
            n_pay * (1 + 2 * crypto) + 3 * refs)
    return f, variants


def both_flushes(fn, torch) -> dict:
    """``time_ms`` of ``fn`` under the write flush and with a clean L2."""
    return {"dirty_l2": time_ms(fn, torch),
            "clean_l2": time_ms(fn, torch, clean_l2=True)}


def empty_kernel_ms(torch) -> dict:
    """This timing's floor under both flushes: ``time_ms`` of a kernel
    that returns at once (``torch.cuda._sleep(0)``, one block of one
    thread)."""
    return both_flushes(lambda: torch.cuda._sleep(0), torch)


def card_line(torch) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    check(smi, "nvidia-smi printed nothing")
    return smi


def timing(size: Size, ss: ServeSize, xs: XlstmSize, dev, torch, np, ops,
           tt):
    rng = np.random.default_rng(29)
    mm = size.meta_max
    rate = peak_ops_per_s(torch, INT32_OPS_PER_SM_CLOCK)
    frate = peak_ops_per_s(torch, FP32_OPS_PER_SM_CLOCK)
    out = {}

    def entry(name, variant, k_fn, r_fn, bnd, lib_fn=None, ops_rate=rate,
              clean=False):
        b_ms, b_by, b_bytes = bound(*bnd, ops_rate)
        row = dict(variant=variant, ms=time_ms(k_fn, torch),
                   plain_ms=time_ms(r_fn, torch, runs=20) if r_fn else None,
                   bound_ms=b_ms, bound_by=b_by, bytes=b_bytes,
                   library_ms=(time_ms(lib_fn, torch) if lib_fn else None))
        if clean:   # the same after a 64 MB read, which leaves no dirty line
            row.update(ms_clean_l2=time_ms(k_fn, torch, clean_l2=True))
            if lib_fn:
                row.update(library_ms_clean_l2=time_ms(lib_fn, torch,
                                                       clean_l2=True))
        out.setdefault(name, []).append(row)
        return row

    floor = empty_kernel_ms(torch)
    emit({"phase": "timing_floor", "empty_kernel_ms": floor["dirty_l2"],
          "empty_kernel_ms_clean_l2": floor["clean_l2"],
          "what": "time_ms of torch.cuda._sleep(0), under the write flush "
                  "and after a clean-L2 read"})
    # selective_copy, beside the floor
    c, _writes, c_cost = copy_timing_case(size, rng, dev, np, tt)
    for crypto in (False, True):
        ks = c["keystream"] if crypto else None
        row = entry("selective_copy", "ks" if crypto else "plain",
                    lambda: ops.selective_copy(c["stream"], c["meta_len"],
                                               c["total_len"], c["pool"],
                                               c["tables"], meta_max=mm,
                                               impl="cuda", keystream=ks),
                    lambda: ops.selective_copy(c["stream"], c["meta_len"],
                                               c["total_len"], c["pool"],
                                               c["tables"], meta_max=mm,
                                               impl="ref", keystream=ks),
                    c_cost(crypto), clean=True)
        row.update(empty_kernel_ms=floor)
    # selective_gather, beside index_select of its rows and a copy_ of as
    # many bytes as it writes
    g, rows_idx, n_g, g_bytes = gather_timing_case(size, rng, dev, np, tt)
    src = torch.empty_like(g["ks"])
    dst = torch.empty_like(src)
    copy_ms = both_flushes(lambda: dst.copy_(src), torch)
    for crypto in (False, True):
        ks = g["ks"] if crypto else None
        row = entry("selective_gather", "ks" if crypto else "plain",
                    lambda: ops.selective_gather(g["pool"], g["tables"],
                                                 g["lengths"], impl="cuda",
                                                 keystream=ks),
                    lambda: ops.selective_gather(g["pool"], g["tables"],
                                                 g["lengths"], impl="ref",
                                                 keystream=ks),
                    (g_bytes(crypto), n_g * crypto),
                    lib_fn=lambda: torch.index_select(g["pool"], 0,
                                                      rows_idx),
                    clean=True)
        row.update(same_bytes_copy_ms=copy_ms)
    del src, dst
    # policy_match: the deployment's three rules, payload window on,
    # beside the floor
    p, p_cost = policy_timing_case(size, rng, dev, np, tt)
    for crypto in (False, True):
        ks = p["ks"] if crypto else None
        row = entry("policy_match", "ks" if crypto else "plain",
                    lambda: ops.policy_match(
                        p["meta"], p["ml"], p["off"], p["lo"], p["hi"],
                        impl="cuda", keystream=ks, payload=p["pw"],
                        payload_len=p["pln"]),
                    lambda: ops.policy_match(
                        p["meta"], p["ml"], p["off"], p["lo"], p["hi"],
                        impl="ref", keystream=ks, payload=p["pw"],
                        payload_len=p["pln"]),
                    p_cost(crypto), clean=True)
        row.update(empty_kernel_ms=floor)
    # fused_round: plaintext with policy, then both keystreams + policy,
    # at each ring depth (the first row, n_buffers = 0, is the main path's)
    f, fvars = fused_timing_case(size, rng, dev, np, tt)
    for vname, (kw, nbytes, nops) in fvars.items():
        for depth in FUSED_DEPTHS:
            entry("fused_round", f"{vname} n_buffers={depth}",
                  lambda: ops.fused_round(f["stream"], f["meta_len"],
                                          f["total_len"], f["pool"],
                                          f["tables"], meta_max=mm,
                                          impl="cuda", n_buffers=depth,
                                          **kw),
                  None if depth else (
                      lambda: ops.fused_round(f["stream"], f["meta_len"],
                                              f["total_len"], f["pool"],
                                              f["tables"], meta_max=mm,
                                              impl="ref", **kw)),
                  (nbytes, nops), clean=True)
    # paged_attention: one layer of a decode step of a full wave
    from repro_torch.configs import get_config

    cfg = get_config(ss.arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    pc, label, flops, nbytes = paged_timing_case(ss, cfg, gen, dev, torch)
    entry("paged_attention", label,
          lambda: ops.paged_attention(*pc, impl="cuda"),
          lambda: ops.paged_attention(*pc, impl="ref"),
          (nbytes, flops), ops_rate=frate)
    # flash_attention: one layer of a prefill of a full wave, causal
    trate = peak_ops_per_s(torch, TF32_OPS_PER_SM_CLOCK)
    (fq, fk, fv), label, flops, nbytes = flash_timing_case(ss, cfg, gen, dev,
                                                           torch)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    entry("flash_attention", label,
          lambda: ops.flash_attention(fq, fk, fv, impl="cuda"),
          lambda: ops.flash_attention(fq, fk, fv, impl="ref"),
          (nbytes, TF32_SPLIT_PASSES * flops),
          lib_fn=lambda: sdpa(fq, fk, fv, is_causal=True, enable_gqa=True),
          ops_rate=trate)
    out["flash_attention"][-1].update(
        function_flop=flops,
        fp32_fma_bound_ms=bound(nbytes, flops, frate)[0])
    del fq, fk, fv, pc
    # mlstm_scan: one mLSTM block of the xLSTM prefill
    mc, label, flops, nbytes = mlstm_timing_case(xs, gen, dev, torch)
    c = xs.chunk
    entry("mlstm_scan", label,
          lambda: ops.mlstm_scan(*mc, chunk=c, impl="cuda",
                                 return_state=True),
          lambda: ops.mlstm_scan(*mc, chunk=c, impl="ref",
                                 return_state=True),
          (nbytes, TF32_SPLIT_PASSES * flops), ops_rate=trate)
    out["mlstm_scan"][-1].update(
        function_flop=flops,
        fp32_fma_bound_ms=bound(nbytes, flops, frate)[0])
    emit({"phase": "timing", "runs": TIMED_RUNS, "empty_kernel_ms": floor,
          "int32_ops_per_s": rate, "fp32_ops_per_s": frate,
          "tf32_ops_per_s": trate,
          "hbm_bytes_per_s": HBM_BYTES_PER_S, "kernels": out})
    return out


# ---------------------------------------------------------------------------
# --mlstm-ab, --flash-ab, --paged-ab: one kernel's checks and timing for
# other builds
# ---------------------------------------------------------------------------

def build_variants(paths, _build, symbol: str, instance: str):
    """Compile each version of one kernel's source into its own library
    under ``build/ab/`` (one ``nvcc`` each, all at once) and load it with
    the C entry point ``symbol``; print each build's ``ptxas -v`` and SASS
    opcode mix of the kernel whose mangled name matches ``instance`` (a
    regular expression)."""
    import ctypes
    import hashlib
    import re

    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, jobs = _build._nvcc(), []
    t0 = time.perf_counter()
    for p in paths:
        src = Path(p).resolve()
        # a header next to the source (an earlier commit's, unpacked with
        # it) is found before the one in csrc/
        headers = sorted(src.parent.glob("*.cuh")) + sorted(
            _build.CSRC.glob("*.cuh"))
        tag = hashlib.sha256(src.read_bytes()
                             + b"".join(h.read_bytes() for h in headers)
                             + " ".join(_build.NVCC_FLAGS).encode())
        so = out_dir / f"{src.stem}_{tag.hexdigest()[:12]}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-Xptxas",
               "-v", "-shared", "-o", str(so), str(src)]
        jobs.append((p, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for p, so, proc in jobs:
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed on {p}:\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, symbol)
        sig = _build.SIGNATURES[symbol]
        decl = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)",
                         Path(p).read_text())
        argc = len([a for a in decl.group(1).split(",") if a.strip()])
        if argc == len(sig) - 1:
            # an entry point from before its last int argument (the
            # fused round's ring depth): the call drops that argument
            fn.argtypes = sig[:-2] + sig[-1:]
            setattr(lib, symbol, lambda *a, _fn=fn: _fn(*a[:-2], a[-1]))
        else:
            check(argc == len(sig), f"{p}: {symbol} takes {argc} arguments")
            fn.argtypes = sig
        fn.restype = ctypes.c_int
        # the error strings live in selective_copy.cu, not in this build
        lib.libra_error_string = lambda rc: b"see cudaError_t"
        libs[p] = lib
        ptxas, run_kernel = [], False
        for ln in log.splitlines():
            if "Compiling entry" in ln:
                run_kernel = re.search(instance, ln) is not None
            elif run_kernel and ("Used" in ln or "spill" in ln):
                ptxas.append(ln.strip())
        emit({"ab_build": p, "ptxas": ptxas,
              "sass": sass_mix(so, nvcc, instance)})
    emit({"ab_build_seconds": time.perf_counter() - t0})
    return libs


def sass_mix(so: Path, nvcc: str, instance: str):
    """The 20 commonest opcodes (with their first modifier) in the code of
    the kernel whose mangled name matches ``instance`` in a built library
    (``cuobjdump``): a static count, and the loops are unrolled."""
    import re

    dump = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(so)], capture_output=True, text=True).stdout
    inside, counts = False, {}
    op = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Z0-9.]*)")
    for ln in dump.splitlines():
        if "Function :" in ln:
            inside = re.search(instance, ln) is not None
            continue
        m = op.search(ln) if inside else None
        if m:
            key = ".".join(m.group(1).split(".")[:2])
            counts[key] = counts.get(key, 0) + 1
    return sorted(counts.items(), key=lambda kv: -kv[1])[:20]


def ab_parity(libs, _build, run) -> dict:
    """``run()`` (a parity phase) through each build, the wrapper's library
    swapped; a build that fails is reported and timed all the same."""
    passed = {}
    for p, lib in libs.items():
        _build._LIB = lib
        emit({"ab_variant": p})
        try:
            run()
            passed[p] = True
        except Exception as exc:  # reported; the other builds still run
            emit({"ab_variant": p, "failed": str(exc)})
            passed[p] = False
    return passed


def ab_times(libs, _build, fn, torch, clean_l2: bool = False) -> dict:
    """Median device time of ``fn()`` through each build, in turns (A B
    ... B A, twice), each a median of ``TIMED_RUNS`` launches; a build
    whose launch fails is reported and left out."""
    def through(lib):
        _build._LIB = lib
        return fn()
    times = {p: [] for p in libs}
    for _ in range(2):
        for p in list(libs) + list(libs)[::-1]:
            if p not in times:
                continue
            try:
                times[p].append(time_ms(lambda: through(libs[p]), torch,
                                        clean_l2=clean_l2))
            except RuntimeError as exc:
                emit({"ab_variant": p, "timing_failed": str(exc)})
                del times[p]
    return times


def tf32_bounds(nbytes, flops, torch) -> dict:
    """The split-TF32 and float32-FMA bounds of a tensor-core kernel."""
    trate = peak_ops_per_s(torch, TF32_OPS_PER_SM_CLOCK)
    frate = peak_ops_per_s(torch, FP32_OPS_PER_SM_CLOCK)
    return {"bound_ms": bound(nbytes, TF32_SPLIT_PASSES * flops, trate)[0],
            "fp32_fma_bound_ms": bound(nbytes, flops, frate)[0]}


def ab_report(phase, label, bounds, times, passed, torch, **extra) -> int:
    """Print one A/B phase line: each build's median time beside the
    function's ``bounds``; 0 if every build passed its parity phase."""
    emit({"phase": phase, "variant": label, "card": card_line(torch),
          "runs_per_time": TIMED_RUNS, **bounds, **extra,
          "ms": {p: statistics.median(t) for p, t in times.items()},
          "ms_each": times, "parity": passed})
    return 0 if all(passed.values()) else 1


def mlstm_ab(paths, dev, torch, np, ops, _build, serve=False) -> int:
    """Phase 7 and the run-shape timing through each build of the mLSTM
    scan; with ``serve``, phase 8 too."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mlstm_scan as kmlstm

    libs = build_variants(paths, _build, "libra_mlstm_scan",
                          "mlstm_scan_kernelILi64ELi512E")
    xs = XlstmSize()

    def run():
        mlstm_parity(xs, get_config(xs.arch), dev, torch, ops)
        if serve:
            xlstm_serve(xs, dev, torch, np, kmlstm)
    passed = ab_parity(libs, _build, run)
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    mc, label, flops, nbytes = mlstm_timing_case(xs, gen, dev, torch)
    times = ab_times(libs, _build, lambda: ops.mlstm_scan(
        *mc, chunk=xs.chunk, impl="cuda", return_state=True), torch)
    return ab_report("mlstm_ab", label, tf32_bounds(nbytes, flops, torch),
                     times, passed, torch)


def flash_ab(paths, dev, torch, ops, _build) -> int:
    """Phase 5's flash_attention cases and the prefill-layer timing through
    each build of the flash attention kernel, and SDPA's time beside them."""
    from repro_torch.configs import get_config

    libs = build_variants(paths, _build, "libra_flash_attention",
                          "flash_attention_kernelILi128E")
    ss = ServeSize()
    cfg = get_config(ss.arch)
    passed = ab_parity(libs, _build, lambda: attn_parity(
        ss, cfg, dev, torch, ops, kernels=("flash_attention",)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    (fq, fk, fv), label, flops, nbytes = flash_timing_case(ss, cfg, gen, dev,
                                                           torch)
    times = ab_times(libs, _build, lambda: ops.flash_attention(
        fq, fk, fv, impl="cuda"), torch)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return ab_report("flash_ab", label, tf32_bounds(nbytes, flops, torch),
                     times, passed, torch,
                     library_ms=time_ms(lambda: sdpa(
                         fq, fk, fv, is_causal=True, enable_gqa=True), torch))


def paged_ab(paths, dev, torch, ops, _build) -> int:
    """Phase 5's paged_attention cases and the decode-layer timing through
    each build of the paged attention kernel, beside the bytes bound of
    phase 9's row and each build's achieved rate."""
    from repro_torch.configs import get_config

    libs = build_variants(paths, _build, "libra_paged_attention",
                          r"paged_attention_kernelILi128E(?:Li3E)?EEv")
    ss = ServeSize()
    cfg = get_config(ss.arch)
    passed = ab_parity(libs, _build, lambda: attn_parity(
        ss, cfg, dev, torch, ops, kernels=("paged_attention",)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    pc, label, flops, nbytes = paged_timing_case(ss, cfg, gen, dev, torch)
    # the same bytes read by one PyTorch reduction, as a yardstick of the
    # rate a plain read reaches under each flush
    flat = torch.randn(nbytes // 4, device=dev)
    return ab_bytes_report(
        "paged_ab", label, libs, _build,
        lambda: ops.paged_attention(*pc, impl="cuda"), torch, passed,
        nbytes, flops, peak_ops_per_s(torch, FP32_OPS_PER_SM_CLOCK),
        same_bytes_sum_ms=both_flushes(flat.sum, torch))


def ab_bytes_report(phase, label, libs, _build, fn, torch, passed, nbytes,
                    ops_, ops_rate, **extra) -> int:
    """Time ``fn()`` through each build in turns under both flushes and
    print one A/B line beside the bound of these bytes and operations:
    each build's TB/s and share of the bound."""
    times = ab_times(libs, _build, fn, torch)
    clean = ab_times(libs, _build, fn, torch, clean_l2=True)
    b_ms, b_by, _ = bound(nbytes, ops_, ops_rate)
    ms = {p: statistics.median(t) for p, t in times.items()}
    ms_clean = {p: statistics.median(t) for p, t in clean.items()}
    return ab_report(phase, label,
                     {"bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes},
                     times, passed, torch,
                     tb_per_s={p: nbytes / t / 1e9 for p, t in ms.items()},
                     share_of_bound={p: b_ms / t for p, t in ms.items()},
                     ms_clean_l2=ms_clean,
                     share_of_bound_clean_l2={p: b_ms / t
                                              for p, t in ms_clean.items()},
                     **extra)


def gather_ab(paths, dev, torch, np, ops, tt, _build) -> int:
    """Phase 1's selective_gather cases and the deployment's gather timing
    (plain and with the TX keystream) through each build of the gather
    kernel, beside ``index_select`` of its rows, a ``copy_`` of as many
    bytes as it writes and a kernel that returns at once."""
    libs = build_variants(paths, _build, "libra_selective_gather",
                          "selective_gather")
    size = Size()
    passed = ab_parity(libs, _build, lambda: parity(
        size, dev, torch, np, ops, tt, kernels=("selective_gather",)))
    g, rows_idx, n_g, nbytes = gather_timing_case(
        size, np.random.default_rng(29), dev, np, tt)
    src = torch.empty_like(g["ks"])
    dst = torch.empty_like(src)
    yard = dict(library_ms=both_flushes(
                    lambda: torch.index_select(g["pool"], 0, rows_idx),
                    torch),
                same_bytes_copy_ms=both_flushes(lambda: dst.copy_(src),
                                                torch),
                empty_kernel_ms=empty_kernel_ms(torch))
    rate = peak_ops_per_s(torch, INT32_OPS_PER_SM_CLOCK)
    rc = 0
    for crypto in (False, True):
        ks = g["ks"] if crypto else None
        rc |= ab_bytes_report(
            "gather_ab", "ks" if crypto else "plain", libs, _build,
            lambda: ops.selective_gather(g["pool"], g["tables"],
                                         g["lengths"], impl="cuda",
                                         keystream=ks),
            torch, passed, nbytes(crypto), n_g * crypto, rate, **yard)
    return rc


def fused_ab(paths, dev, torch, np, ops, tt, _build) -> int:
    """Phase 1's fused_round cases and the deployment's fused-round timing
    (plain + policy, both keystreams + policy, and plain without the
    policy table) at each ring depth through each build of the fused
    round kernel (an entry point without the depth argument runs every
    depth alike), beside a kernel that returns at once."""
    libs = build_variants(paths, _build, "libra_fused_round",
                          "fused_round")
    size = Size()
    passed = ab_parity(libs, _build, lambda: parity(
        size, dev, torch, np, ops, tt, kernels=("fused_round",)))
    f, fvars = fused_timing_case(size, np.random.default_rng(29), dev, np,
                                 tt)
    kw, nbytes, nops = fvars["plain+policy"]
    # without the table: the verdict's table, tokens and output drop out
    fvars["plain, no policy"] = ({}, nbytes - 4 * (
        3 * f["cond_off"].numel() + policy_refs(
            f["cond_off"].cpu().numpy(), f["meta_len"].cpu().numpy(),
            size.meta_max, (f["total_len"] - f["meta_len"]).cpu().numpy(),
            size.page, np) + size.channels), 0)
    rate = peak_ops_per_s(torch, INT32_OPS_PER_SM_CLOCK)
    floor = empty_kernel_ms(torch)
    rc = 0
    for vname, (kw, nbytes, nops) in fvars.items():
        for depth in PROFILE_DEPTHS:
            rc |= ab_bytes_report(
                "fused_ab", f"{vname} n_buffers={depth}", libs, _build,
                lambda: ops.fused_round(f["stream"], f["meta_len"],
                                        f["total_len"], f["pool"],
                                        f["tables"], meta_max=size.meta_max,
                                        impl="cuda", n_buffers=depth, **kw),
                torch, passed, nbytes, nops, rate, empty_kernel_ms=floor)
    return rc


def copy_ab(paths, dev, torch, np, ops, tt, _build) -> int:
    """Phase 1's selective_copy cases and the deployment's RX copy timing
    (plain and with the keystream) through each build of the selective
    copy kernel, beside a ``copy_`` of as many bytes as it writes and a
    kernel that returns at once."""
    libs = build_variants(paths, _build, "libra_selective_copy",
                          r"selective_copy_kernel(?:ILi1EEEv|E)PKi")
    size = Size()
    passed = ab_parity(libs, _build, lambda: parity(
        size, dev, torch, np, ops, tt, kernels=("selective_copy",)))
    c, writes, cost = copy_timing_case(size, np.random.default_rng(29), dev,
                                       np, tt)
    src = torch.zeros(writes, dtype=torch.int32, device=dev)
    dst = torch.empty_like(src)
    yard = dict(same_bytes_copy_ms=both_flushes(lambda: dst.copy_(src),
                                                torch),
                empty_kernel_ms=empty_kernel_ms(torch))
    rate = peak_ops_per_s(torch, INT32_OPS_PER_SM_CLOCK)
    rc = 0
    for crypto in (False, True):
        ks = c["keystream"] if crypto else None
        rc |= ab_bytes_report(
            "copy_ab", "ks" if crypto else "plain", libs, _build,
            lambda: ops.selective_copy(c["stream"], c["meta_len"],
                                       c["total_len"], c["pool"],
                                       c["tables"], meta_max=size.meta_max,
                                       impl="cuda", keystream=ks),
            torch, passed, *cost(crypto), rate, **yard)
    return rc


def policy_ab(paths, dev, torch, np, ops, tt, _build) -> int:
    """Phase 1's policy_match cases and the deployment's policy timing
    (payload window on, plain and with the keystream) through each build
    of the policy match kernel, beside a kernel that returns at once."""
    libs = build_variants(paths, _build, "libra_policy_match",
                          "policy_match_kernel")
    size = Size()
    passed = ab_parity(libs, _build, lambda: parity(
        size, dev, torch, np, ops, tt, kernels=("policy_match",)))
    p, cost = policy_timing_case(size, np.random.default_rng(29), dev, np,
                                 tt)
    floor = empty_kernel_ms(torch)
    rate = peak_ops_per_s(torch, INT32_OPS_PER_SM_CLOCK)
    rc = 0
    for crypto in (False, True):
        ks = p["ks"] if crypto else None
        rc |= ab_bytes_report(
            "policy_ab", "ks" if crypto else "plain", libs, _build,
            lambda: ops.policy_match(p["meta"], p["ml"], p["off"], p["lo"],
                                     p["hi"], impl="cuda", keystream=ks,
                                     payload=p["pw"], payload_len=p["pln"]),
            torch, passed, *cost(crypto), rate, empty_kernel_ms=floor)
    return rc


# ---------------------------------------------------------------------------

def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SmokeError("src/repro_torch not found next to chip_smoke.py: "
                         "run it from the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("no CUDA device: the smoke run needs one GPU")
    # float32 products in full float32: the plain versions are references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import mlstm_scan as kmlstm
    from repro_torch.kernels import selective_copy as kern
    from repro_torch.kernels import testing as tt

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if sys.argv[1:2] == ["--mlstm-ab"]:
        with_serve = sys.argv[2:3] == ["--serve"]
        srcs = sys.argv[2 + with_serve:]
        check(srcs, "--mlstm-ab takes mlstm_scan.cu sources")
        return mlstm_ab(srcs, dev, torch, np, ops, _build, with_serve)
    if sys.argv[1:2] == ["--flash-ab"]:
        check(sys.argv[2:], "--flash-ab takes flash_attention.cu sources")
        return flash_ab(sys.argv[2:], dev, torch, ops, _build)
    if sys.argv[1:2] == ["--paged-ab"]:
        check(sys.argv[2:], "--paged-ab takes paged_attention.cu sources")
        return paged_ab(sys.argv[2:], dev, torch, ops, _build)
    if sys.argv[1:2] == ["--gather-ab"]:
        check(sys.argv[2:], "--gather-ab takes selective_gather.cu sources")
        return gather_ab(sys.argv[2:], dev, torch, np, ops, tt, _build)
    if sys.argv[1:2] == ["--fused-ab"]:
        check(sys.argv[2:], "--fused-ab takes fused_round.cu sources")
        return fused_ab(sys.argv[2:], dev, torch, np, ops, tt, _build)
    if sys.argv[1:2] == ["--copy-ab"]:
        check(sys.argv[2:], "--copy-ab takes selective_copy.cu sources")
        return copy_ab(sys.argv[2:], dev, torch, np, ops, tt, _build)
    if sys.argv[1:2] == ["--policy-ab"]:
        check(sys.argv[2:], "--policy-ab takes policy_match.cu sources")
        return policy_ab(sys.argv[2:], dev, torch, np, ops, tt, _build)
    size = Size()
    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.relative_to(ROOT)),
          "sources": [str(p.relative_to(ROOT)) for p in _build.sources()],
          "torch": torch.__version__, "cuda": torch.version.cuda})

    phase_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    par = timed("parity", parity, size, dev, torch, np, ops, tt)
    runs = {}
    for tls in (None, "hw"):
        runs[tls or "plaintext"] = timed(f"e2e_{tls or 'plaintext'}", e2e,
                                         size, tls, dev, torch, np, core, kern)
    timed("trace", trace, size, dev, torch, np, core)
    timed("cluster", cluster, size, dev, torch, np, core, kern)
    timed("depth", depth, size, dev, torch, np, core, kern)
    ss = ServeSize()
    cfg = get_config(ss.arch)
    apar = timed("attn_parity", attn_parity, ss, cfg, dev, torch, ops)
    srv = timed("serve", serve, ss, dev, torch, np, kattn)
    xs = XlstmSize()
    mpar = timed("mlstm_parity", mlstm_parity, xs, get_config(xs.arch), dev,
                 torch, ops)
    xsrv = timed("xlstm_serve", xlstm_serve, xs, dev, torch, np, kmlstm)
    tim = timed("timing", timing, size, ss, xs, dev, torch, np, ops, tt)
    emit({"phase_seconds": phase_s})

    print(card_line(torch), flush=True)

    kernels = []
    for name, replaces in KERNELS.items():
        first = tim[name][0]
        if name in DATAPATH:
            launches = sum(r["launches"][name] for rs in runs.values()
                           for r in rs)
            err = max(r["max_abs_err"] for r in par if r["kernel"] == name)
        elif name == "mlstm_scan":
            launches = xsrv["launches"][name]
            err = max(r["max_abs_err"] for r in mpar)
        else:
            launches = srv["launches"][name]
            err = max(r["max_abs_err"] for r in apar if r["kernel"] == name)
        check(launches > 0, f"{name} never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "variant": first["variant"],
        })
        if "fp32_fma_bound_ms" in first:
            kernels[-1]["fp32_fma_bound_ms"] = first["fp32_fma_bound_ms"]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # every failure is fatal: no result line
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
