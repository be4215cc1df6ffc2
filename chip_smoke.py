#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the four datapath kernels from ``src/repro_torch/kernels/csrc``
into ``build/kernels/`` and then runs, in order:

1. **parity** -- each kernel against its plain PyTorch version on the card,
   on seeded cases at the deployment shapes and at small ragged ones, with
   every optional operand on and off. Outputs must be bit-identical
   (``torch.equal``, the whole pool after the in-place anchor included) and
   the pool tensor must keep its storage.
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
4. **timing** -- each kernel, its plain version and (where one exists) a
   single PyTorch library call at the deployment shapes: CUDA events around
   each launch, L2 flushed before it, median of 30 launches; the bound is
   the larger of the bytes the function must move over 3.35 TB/s and its
   int32 operations over the card's int32 peak.

Each phase prints one JSON line. Then come the card's name and power limit
(``nvidia-smi``), the ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
last line; with no CUDA device, or outside a checkout, it fails at once.
"""
from __future__ import annotations

import dataclasses
import json
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
TIMED_RUNS = 30
SPIN_CYCLES = 1_000_000     # ~0.5 ms at H100 clocks: longer than an enqueue

KERNELS = {
    "selective_copy": "src/repro/kernels/selective_copy.py:94",
    "selective_gather": "src/repro/kernels/selective_copy.py:364",
    "policy_match": "src/repro/kernels/selective_copy.py:265",
    "fused_round": "src/repro/kernels/selective_copy.py:554",
}


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


def parity(size: Size, dev, torch, np, ops, tt):
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
    # -- selective_copy: deployment, small ragged, edge rows --------------
    cases = [("deploy", widen(selcopy_dict(tt.selcopy_crypto_case(rng, **big)),
                              size.pool_rows, rng, np), size.meta_max),
             ("small", selcopy_dict(tt.selcopy_crypto_case(rng, **SMALL)),
              SMALL["meta_max"]),
             ("edge", selcopy_dict(tt.edge_rows_case()), 8)]
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
    # -- selective_gather ---------------------------------------------------
    gcases = [("deploy", tt.selgather_case(
        rng, b=size.channels, page=size.page, pps=size.pps,
        p_total=size.pool_rows - 1)),
        ("small", tt.selgather_case(rng, b=SMALL["b"], page=SMALL["page"],
                                    pps=SMALL["pps"]))]
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
    # -- policy_match: the deployment table, a wide table, small ---------
    pcases = [("deploy", tt.policy_payload_case(
        rng, b=size.channels, meta_max=size.meta_max, r=3, k=1,
        w=size.page), 3),
        ("wide", tt.policy_payload_case(rng, b=9, meta_max=40, r=70, k=40,
                                        w=16), 70),
        ("small", tt.policy_payload_case(rng, b=6, meta_max=12, r=7, k=3,
                                         w=8), 7)]
    variants = {"plain": (), "ks": ("ks",), "live": ("live",),
                "payload": ("payload",), "all": ("ks", "live", "payload")}
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
    t = tt.to_torch(dict(meta=pcases[2][1][0], ml=pcases[2][1][1],
                         none=np.zeros((0, 3), np.int32)), dev)
    ok, orr = run_pair(
        lambda _p: (ops.policy_match(t["meta"], t["ml"], t["none"], t["none"],
                                     t["none"], impl="cuda"),),
        lambda _p: (ops.policy_match(t["meta"], t["ml"], t["none"], t["none"],
                                     t["none"], impl="ref"),),
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
    fcases = [("deploy", widen(tt.fused_round_case(rng, r=3, k=1, **big),
                               size.pool_rows, rng, np), size.meta_max),
              ("small", tt.fused_round_case(rng, r=6, k=3, **SMALL),
               SMALL["meta_max"])]
    for label, case, meta_max in fcases:
        for oname, keys in operand_sets.items():
            c = tt.to_torch(case, dev)
            kw = {k: c[k] for k in keys}

            def run(impl, pool):
                return ops.fused_round(
                    c["stream"], c["meta_len"], c["total_len"], pool,
                    c["tables"], meta_max=meta_max, impl=impl, **kw)
            pk, pr = c["pool"], c["pool"].clone()
            ok, orr = run_pair(lambda p: run("cuda", p),
                               lambda p: run("ref", p), pk, pr, torch)
            check(ok[1] is pk, "fused_round returned another pool")
            record("fused_round", f"{label}/{oname}", ok, orr)
    emit({"phase": "parity", "cases": len(results),
          "all_equal": all(r["equal"] for r in results),
          "max_abs_err": {k: max(r["max_abs_err"] for r in results
                                 if r["kernel"] == k) for k in KERNELS}})
    return results


# ---------------------------------------------------------------------------
# phases 2-3: end to end
# ---------------------------------------------------------------------------

def build_run(size: Size, impl: str, tls, dev, np, core):
    """The deployment's stack, policy table and loaded runtime."""
    from repro_torch.core.crypto import REC_HEADER
    from repro_torch.core.policy import payload_at

    stack = core.LibraStack(n_shards=size.n_shards,
                            pages_per_shard=size.pages_per_shard,
                            page_size=size.page, secret=b"chip-smoke",
                            device=dev)
    off = (REC_HEADER if tls else 0) + 3
    table = core.PolicyTable([
        core.rule(core.drop(), core.between(off, 196, 199)),
        core.rule(core.forward(1), payload_at(0, 1950, 2000)),
        core.rule(core.forward(0), core.between(off, 100, 199)),
    ])
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
        frames = [core.build_message(
            rng.integers(100, 200, size.meta_app(tls)),
            rng.integers(1000, 2000,
                         int(rng.integers(size.payload_lo,
                                          size.payload_hi + 1))))
            for _ in range(size.msgs)]
        src.deliver(src.tls.seal_frames(frames, src.parser.inner) if tls
                    else np.concatenate(frames))
    return stack, rt, table


def e2e_run(size: Size, impl: str, tls, dev, torch, np, core, kern):
    stack, rt, table = build_run(size, impl, tls, dev, np, core)
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
    wires = [d.tls.open_wire(d.tx_wire()) if tls else d.tx_wire()
             for ch in rt.channels for d in ch.dsts]
    out = dict(impl=impl, rounds=rt.rounds, seconds=dt,
               resident_init_seconds=resident_s,
               rounds_per_s=rt.rounds / dt,
               msgs=rt.messages_forwarded(),
               msgs_per_s=rt.messages_forwarded() / dt,
               launches=launches, xfer=dict(stack.pool.xfer),
               counters=dataclasses.asdict(stack.counters),
               verdicts=table.summary())
    rt.shutdown()
    check(stack.alloc.free_pages == stack.alloc.total_pages,
          f"{impl}: pages leaked after shutdown")
    return out, wires


def e2e(size: Size, tls, dev, torch, np, core, kern):
    # kernels each run must launch, and kernels it must not: a fused round
    # anchors and matches in its one launch, but sends its speculation
    # missed (policy reroutes, drops) still gather in their own launch
    expect = {"fused-round": (("fused_round",),
                              ("selective_copy", "policy_match")),
              "auto": (("selective_copy", "policy_match", "selective_gather"),
                       ("fused_round",)),
              "host": ((), tuple(KERNELS))}
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
        check(all(np.array_equal(a, b) for a, b in zip(w, wires[base_i])),
              f"{tag}: wire bytes differ from the host run")
        check(r["counters"] == base["counters"],
              f"{tag}: CopyCounters differ from the host run")
        check(r["verdicts"] == base["verdicts"],
              f"{tag}: policy verdicts differ from the host run")
        check(r["msgs"] == base["msgs"], f"{tag}: message count differs")
        x = r["xfer"]
        check(x["pool_syncs"] == 0, f"{tag}: O(pool) sync happened")
        check(x.get("host_gathers", 0) == 0,
              f"{tag}: {x.get('host_gathers')} batched gathers ran on the "
              "host while the pool was resident")
        check(x["donated_rounds"] == x["device_rounds"],
              f"{tag}: donated_rounds != device_rounds")
        must, must_not = expect[impl]
        for k in must:
            check(r["launches"][k] > 0, f"{tag}: kernel {k} was never launched")
        for k in must_not:
            check(r["launches"][k] == 0,
                  f"{tag}: kernel {k} launched {r['launches'][k]} times")
        if impl != "host":
            check(x["device_rounds"] > 0, f"{tag}: no device round")
            check(r["counters"]["device_fallbacks"] == 0,
                  f"{tag}: rounds fell back to the host")
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
# phase 4: timing
# ---------------------------------------------------------------------------

def time_ms(fn, torch, runs: int = TIMED_RUNS) -> float:
    """Median device time of ``fn`` in ms: CUDA events around each call,
    the 50 MB L2 flushed before it (the round's operands arrive cold). A
    spin kernel holds the stream while the host enqueues the start event,
    the call and the end event, so the host's launch overhead is not
    counted; a call that waits on the device itself (the plain versions'
    masked indexing) still counts its host gaps."""
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
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


def int32_ops_per_s(torch) -> float:
    """Peak int32 operations per second of the current card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = subprocess.run(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip()
    return sms * INT32_OPS_PER_SM_CLOCK * float(mhz) * 1e6


def bound(bytes_: int, ops_: int, ops_per_s: float):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / ops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            bytes_)


def timing(size: Size, dev, torch, np, ops, tt):
    rng = np.random.default_rng(29)
    big = dict(b=size.channels, page=size.page, pps=size.pps,
               meta_max=size.meta_max)
    page, mm = size.page, size.meta_max
    rate = int32_ops_per_s(torch)
    out = {}

    def entry(name, variant, k_fn, r_fn, bnd, lib_fn=None):
        b_ms, b_by, b_bytes = bound(*bnd, rate)
        row = dict(variant=variant, ms=time_ms(k_fn, torch),
                   plain_ms=time_ms(r_fn, torch, runs=20),
                   bound_ms=b_ms, bound_by=b_by, bytes=b_bytes,
                   library_ms=(time_ms(lib_fn, torch) if lib_fn else None))
        out.setdefault(name, []).append(row)

    # selective_copy
    case = widen(selcopy_dict(tt.selcopy_crypto_case(rng, **big)),
                 size.pool_rows, rng, np)
    c = tt.to_torch(case, dev)
    ml, tl, tb = case["meta_len"], case["total_len"], case["tables"]
    b, s = case["stream"].shape
    n_pay = anchored_tokens(ml, tl, tb, page, s, np)
    n_meta = int(np.minimum(ml, mm).sum())
    idx = tb.size + 2 * b
    for crypto in (False, True):
        ks = c["keystream"] if crypto else None
        reads = n_pay * (2 if crypto else 1) + n_meta + idx
        writes = n_pay + b * mm
        entry("selective_copy", "ks" if crypto else "plain",
              lambda: ops.selective_copy(c["stream"], c["meta_len"],
                                         c["total_len"], c["pool"],
                                         c["tables"], meta_max=mm,
                                         impl="cuda", keystream=ks),
              lambda: ops.selective_copy(c["stream"], c["meta_len"],
                                         c["total_len"], c["pool"],
                                         c["tables"], meta_max=mm,
                                         impl="ref", keystream=ks),
              (4 * (reads + writes), n_pay * (1 + crypto)))
    # selective_gather
    pool, tables, lengths, gks = tt.selgather_case(
        rng, b=size.channels, page=page, pps=size.pps,
        p_total=size.pool_rows - 1)
    g = tt.to_torch(dict(pool=pool, tables=tables, lengths=lengths, ks=gks),
                    dev)
    n_g = gathered_tokens(tables, lengths, page, np)
    rows_idx = g["tables"].reshape(-1).long().clamp(min=0)
    for crypto in (False, True):
        ks = g["ks"] if crypto else None
        reads = n_g * (2 if crypto else 1) + tables.size + len(lengths)
        writes = tables.size * page
        entry("selective_gather", "ks" if crypto else "plain",
              lambda: ops.selective_gather(g["pool"], g["tables"],
                                           g["lengths"], impl="cuda",
                                           keystream=ks),
              lambda: ops.selective_gather(g["pool"], g["tables"],
                                           g["lengths"], impl="ref",
                                           keystream=ks),
              (4 * (reads + writes), n_g * crypto),
              lib_fn=lambda: torch.index_select(g["pool"], 0, rows_idx))
    # policy_match: the deployment's three rules, payload window on
    meta, pml, off, lo, hi, pks, pw, pln = tt.policy_payload_case(
        rng, b=size.channels, meta_max=mm, r=3, k=1, w=page)
    p = tt.to_torch(dict(meta=meta, ml=pml, off=off, lo=lo, hi=hi, ks=pks,
                         pw=pw, pln=pln), dev)
    refs = policy_refs(off, pml, mm, pln, page, np)
    for crypto in (False, True):
        ks = p["ks"] if crypto else None
        reads = refs * (2 if crypto else 1) + 3 * off.size + 2 * len(pml)
        entry("policy_match", "ks" if crypto else "plain",
              lambda: ops.policy_match(p["meta"], p["ml"], p["off"], p["lo"],
                                       p["hi"], impl="cuda", keystream=ks,
                                       payload=p["pw"], payload_len=p["pln"]),
              lambda: ops.policy_match(p["meta"], p["ml"], p["off"], p["lo"],
                                       p["hi"], impl="ref", keystream=ks,
                                       payload=p["pw"], payload_len=p["pln"]),
              (4 * (reads + len(pml)), 3 * refs))
    # fused_round: plaintext with policy; then both keystreams + policy
    case = widen(tt.fused_round_case(rng, r=3, k=1, **big), size.pool_rows,
                 rng, np)
    f = tt.to_torch(case, dev)
    ml, tl, tb = case["meta_len"], case["total_len"], case["tables"]
    b, s = case["stream"].shape
    n_pay = anchored_tokens(ml, tl, tb, page, s, np)
    n_meta = int(np.minimum(ml, mm).sum())
    refs = policy_refs(case["cond_off"], ml, mm, tl - ml, page, np)
    for crypto in (False, True):
        keys = ["cond_off", "cond_lo", "cond_hi"]
        if crypto:
            keys += ["keystream", "tx_keystream"]
        kw = {k: f[k] for k in keys}
        per_tok = 3 if crypto else 1        # stream (+ RX ks, + TX ks)
        reads = (n_pay * per_tok + n_meta + refs * (2 if crypto else 1)
                 + tb.size + 2 * b + 3 * case["cond_off"].size)
        writes = n_pay + b * mm + tb.size * page + b
        entry("fused_round", "ks+policy" if crypto else "plain+policy",
              lambda: ops.fused_round(f["stream"], f["meta_len"],
                                      f["total_len"], f["pool"], f["tables"],
                                      meta_max=mm, impl="cuda", **kw),
              lambda: ops.fused_round(f["stream"], f["meta_len"],
                                      f["total_len"], f["pool"], f["tables"],
                                      meta_max=mm, impl="ref", **kw),
              (4 * (reads + writes), n_pay * (1 + 2 * crypto) + 3 * refs))
    emit({"phase": "timing", "runs": TIMED_RUNS,
          "int32_ops_per_s": rate, "hbm_bytes_per_s": HBM_BYTES_PER_S,
          "kernels": out})
    return out


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
    import repro_torch.core as core
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import selective_copy as kern
    from repro_torch.kernels import testing as tt

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    size = Size()
    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(lib.relative_to(ROOT)),
          "sources": [str(p.relative_to(ROOT)) for p in _build.sources()],
          "torch": torch.__version__, "cuda": torch.version.cuda})

    par = parity(size, dev, torch, np, ops, tt)
    runs = {}
    for tls in (None, "hw"):
        runs[tls or "plaintext"] = e2e(size, tls, dev, torch, np, core, kern)
    trace(size, dev, torch, np, core)
    tim = timing(size, dev, torch, np, ops, tt)

    smi = subprocess.run(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    check(smi, "nvidia-smi printed nothing")
    print(smi, flush=True)

    kernels = []
    for name, replaces in KERNELS.items():
        first = tim[name][0]
        launches = sum(r["launches"][name] for rs in runs.values()
                       for r in rs)
        check(launches > 0, f"{name} never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in par
                               if r["kernel"] == name),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "variant": first["variant"],
        })
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
