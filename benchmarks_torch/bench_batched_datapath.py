"""Batched vs scalar proxy datapath (the round-amortization experiment).

The port's ``benchmarks/bench_batched_datapath.py``: the same rows, series
(N in {8, 64, 256}; kernel mode; resident vs host-sync; the one-kernel
round at N = 64), repetitions and identity asserts. In full mode every
stack, header and payload is :data:`common.DEPLOYMENT`'s.

One ``ProxyRuntime.step()`` in batched mode gathers every ready channel's
admissible frame into a single ``LibraStack.recv_batch``/``forward_batch``
pair. Reported per connection count N:

  * msgs/s scalar vs batched (best-of-k interleaved, same workload/seed),
  * per-round wall latency and per-quantum p50/p99 from the channel
    latency histograms,
  * a CopyCounters identity check: the batched path copies exactly the
    tokens the scalar path copies.

The reference's kernel-driven ``batch_impl='ref'`` and
``'fused-round:ref'`` are the port's ``'auto'`` and ``'fused-round'``: the
CUDA kernels on the card, their plain versions on the CPU (the port's
``'ref'`` is the plain version on any device, so it would bypass every
kernel). The ``host_sync`` series runs the legacy host pool
(``device_pool=False``), which uploads the whole pool and syncs the
touched rows back every device round::

    PYTHONPATH=src python -m benchmarks_torch.bench_batched_datapath
"""
from __future__ import annotations

import time

import numpy as np

from benchmarks_torch.common import DEPLOYMENT, bench_args, counters_fields, \
    csv, is_smoke, record, run_stream, stream_kw, sync

MIXED = ["length-prefixed", "delimiter", "chunked"]

FUSED_N = 64   # the acceptance point: one-kernel vs three-launch at N=64

#: the reference's kernel impls, in the port's names
KERNEL_IMPL = "auto"
FUSED_IMPL = "fused-round"


def run_fused_once(impl: str, *, n_conns: int, n_msgs: int, payload: int,
                   seed: int = 3, device="cuda"):
    """One policy-routed proxy run for the one-kernel series: an L7 table
    (metadata route + payload-prefix route + drop) makes the multi-pass
    path pay its three launches per round (anchor + policy match + egress
    gather) while ``impl='fused-round'`` folds them into one, with the
    egress gather riding the round as a speculative TX against each
    channel's primary backend."""
    from repro_torch.core import (LibraStack, PolicyTable, ProxyRuntime,
                                  between, build_message, drop, forward, rule)
    from repro_torch.core.policy import payload_at

    smoke = is_smoke()
    geo = (dict(n_shards=4, pages_per_shard=2048, page_size=16) if smoke
           else DEPLOYMENT.stack_kw)
    meta = 8 if smoke else DEPLOYMENT.meta
    stack = LibraStack(secret=b"bench", device_pool=True, device=device,
                       **geo)
    table = PolicyTable([
        rule(drop(), between(0, 196, 199)),
        rule(forward(1), payload_at(0, 1950, 2000)),
        rule(forward(0), between(0, 100, 199)),
    ])
    rt = ProxyRuntime(stack, tick_every=32, policy=table, batched=True,
                      batch_impl=impl)
    rng = np.random.default_rng(seed)
    for i in range(n_conns):
        src = stack.socket("length-prefixed")
        dsts = [stack.socket("length-prefixed") for _ in range(2)]
        rt.channel(src, dsts, name=f"ch{i}")
        for _ in range(n_msgs):
            src.deliver(build_message(rng.integers(100, 200, meta),
                                      rng.integers(1000, 2000, payload)))
    t0 = time.perf_counter()
    rt.run()
    sync(device)
    dt = time.perf_counter() - t0
    wires = tuple(d.tx_wire().tobytes()
                  for ch in rt.channels for d in ch.dsts)
    rt.shutdown()
    assert stack.alloc.free_pages == stack.alloc.total_pages
    return stack, rt, n_conns * n_msgs, dt, wires


def run_once(*, n_conns: int, n_msgs: int, payload: int, batched: bool,
             batch_impl: str = "host", parsers=None, device_pool=True,
             device="cuda"):
    return run_stream(n_conns=n_conns, n_msgs=n_msgs, payload=payload,
                      parsers=parsers or MIXED, batched=batched,
                      batch_impl=batch_impl, device_pool=device_pool,
                      device=device, **stream_kw())


def _percentiles(rt) -> tuple:
    hists = [c.stats.latency for c in rt.channels]
    tot = sum(h.count for h in hists)
    if not tot:
        return 0.0, 0.0
    # channel-count-weighted medians are close enough for telemetry lines
    p50 = sorted(h.percentile(0.5) for h in hists)[len(hists) // 2]
    p99 = max(h.percentile(0.99) for h in hists)
    return p50, p99


def main(argv=None) -> None:
    device = bench_args(argv, __doc__).device
    smoke = is_smoke()
    n_msgs = 4 if smoke else 16
    payload = 64 if smoke else DEPLOYMENT.payload
    reps = 2 if smoke else 3
    conn_counts = (8, 64, 256)

    for n_conns in conn_counts:
        rows = {}
        for name, kw in (("scalar", dict(batched=False)),
                         ("batched", dict(batched=True))):
            best = None
            for _ in range(reps):   # interleaving is per-config; best-of-k
                stack, rt, msgs, dt = run_once(
                    n_conns=n_conns, n_msgs=n_msgs, payload=payload,
                    device=device, **kw)
                if best is None or dt < best[3]:
                    best = (stack, rt, msgs, dt)
            rows[name] = best
        sc, bc = rows["scalar"][0].counters, rows["batched"][0].counters
        counters_match = sc.snapshot() == bc.snapshot()
        for name, (stack, rt, msgs, dt) in rows.items():
            p50, p99 = _percentiles(rt)
            tput = msgs / max(dt, 1e-9)
            csv(f"batched_datapath_c{n_conns}_{name}",
                1e6 / max(tput, 1e-9),
                f"msgs_per_s={tput:.0f} rounds={rt.rounds} "
                f"round_us={dt * 1e6 / max(rt.rounds, 1):.1f} "
                f"q_p50_us={p50 * 1e6:.1f} q_p99_us={p99 * 1e6:.1f} "
                f"counters_match={counters_match}")
            record(f"batched_datapath_c{n_conns}_{name}_counters",
                   impl="host", n_conns=n_conns, msgs_per_s=tput,
                   counters_match=bool(counters_match),
                   **counters_fields(stack))
        s_tput = rows["scalar"][2] / max(rows["scalar"][3], 1e-9)
        b_tput = rows["batched"][2] / max(rows["batched"][3], 1e-9)
        csv(f"batched_datapath_c{n_conns}_speedup", 0.0,
            f"batched_over_scalar={b_tput / max(s_tput, 1e-9):.2f}x")

    # kernel-driven mode: the kernels (their plain versions on the CPU)
    # serve the batched rounds, wire-identical
    t0 = time.time()
    stack_h, rt_h, msgs_h, _ = run_once(n_conns=8, n_msgs=n_msgs,
                                        payload=payload, batched=True,
                                        device=device)
    stack_k, rt_k, msgs_k, _ = run_once(n_conns=8, n_msgs=n_msgs,
                                        payload=payload, batched=True,
                                        batch_impl=KERNEL_IMPL,
                                        device=device)
    same = (stack_h.counters.snapshot() == stack_k.counters.snapshot()
            and msgs_h == msgs_k)
    csv("batched_datapath_kernel_mode", (time.time() - t0) * 1e6,
        f"impl={KERNEL_IMPL} counters_match={same} msgs={msgs_k}")
    record("batched_datapath_kernel_mode_counters", impl=KERNEL_IMPL,
           counters_match=bool(same), **counters_fields(stack_k))

    # resident vs host-sync device rounds: the same kernel-driven batched
    # workload against (a) the resident DevicePool (no pool-sized boundary
    # crossing a round) and (b) the legacy host pool that uploads the
    # whole pool and syncs the touched rows back every round
    n_res = 8 if smoke else 32
    series = {}
    for name, device_pool in (("resident", True), ("host_sync", False)):
        best = None
        for _ in range(reps):
            stack, rt, msgs, dt = run_once(
                n_conns=n_res, n_msgs=n_msgs, payload=payload, batched=True,
                batch_impl=KERNEL_IMPL, parsers=["length-prefixed"],
                device_pool=device_pool, device=device)
            if best is None or dt < best[3]:
                best = (stack, rt, msgs, dt)
        series[name] = best
        stack, rt, msgs, dt = best
        x = stack.pool.xfer
        rounds_s = rt.rounds / max(dt, 1e-9)
        csv(f"batched_datapath_device_{name}", dt * 1e6 / max(rt.rounds, 1),
            f"rounds_per_s={rounds_s:.0f} msgs_per_s={msgs / max(dt, 1e-9):.0f} "
            f"pool_syncs={x['pool_syncs']} device_rounds={x['device_rounds']} "
            f"h2d_tokens={x['h2d_tokens']} d2h_tokens={x['d2h_tokens']}")
        record(f"batched_datapath_device_{name}_counters", impl=KERNEL_IMPL,
               n_conns=n_res, rounds_per_s=rounds_s,
               **counters_fields(stack))
    # the one-kernel scheduling round: anchor + policy match + egress
    # gather as one launch a round vs the multi-pass three, same
    # policy-routed workload at N=64. Identity is asserted per pair (wire
    # bytes, the CopyCounters snapshot, forwarded message count) before
    # the speedup is reported.
    fused_msgs = 4 if smoke else 8
    fused_payload = 96 if smoke else DEPLOYMENT.payload
    fused = {}
    for _ in range(reps):       # interleaved best-of-k, same seed
        for impl in (KERNEL_IMPL, FUSED_IMPL):
            got = run_fused_once(impl, n_conns=FUSED_N, n_msgs=fused_msgs,
                                 payload=fused_payload, device=device)
            if impl not in fused or got[3] < fused[impl][3]:
                fused[impl] = got
    multi, one = fused[KERNEL_IMPL], fused[FUSED_IMPL]
    assert multi[4] == one[4], "fused round: wire bytes differ"
    assert multi[0].counters.snapshot() == one[0].counters.snapshot(), \
        "fused round: copy counters differ"
    assert multi[1].messages_forwarded() == one[1].messages_forwarded()
    for name, (stack, rt, msgs, dt, _) in (("multi_pass", multi),
                                           ("fused", one)):
        x = stack.pool.xfer
        rounds_s = rt.rounds / max(dt, 1e-9)
        launches = x["device_rounds"] + x["policy_match_rounds"]
        csv(f"batched_datapath_fused_c{FUSED_N}_{name}",
            dt * 1e6 / max(rt.rounds, 1),
            f"rounds_per_s={rounds_s:.0f} msgs_per_s={msgs / max(dt, 1e-9):.0f} "
            f"launches={launches} fused_rounds={x['fused_rounds']} "
            f"tx_spec_hits={x['tx_spec_hits']}")
        record(f"batched_datapath_fused_c{FUSED_N}_{name}_series",
               impl=KERNEL_IMPL if name == "multi_pass" else FUSED_IMPL,
               n_conns=FUSED_N, rounds_per_s=rounds_s,
               msgs_per_s=msgs / max(dt, 1e-9), launches=launches,
               **counters_fields(stack))
    f_tput = one[1].rounds / max(one[3], 1e-9)
    m_tput = multi[1].rounds / max(multi[3], 1e-9)
    mx, ox = multi[0].pool.xfer, one[0].pool.xfer
    csv(f"batched_datapath_fused_c{FUSED_N}_speedup", 0.0,
        f"fused_over_multi={f_tput / max(m_tput, 1e-9):.2f}x "
        f"launches_{mx['device_rounds'] + mx['policy_match_rounds']}"
        f"_to_{ox['device_rounds'] + ox['policy_match_rounds']}")
    record(f"batched_datapath_fused_c{FUSED_N}_speedup_series",
           fused_over_multi=f_tput / max(m_tput, 1e-9),
           multi_launches=mx["device_rounds"] + mx["policy_match_rounds"],
           fused_launches=ox["device_rounds"] + ox["policy_match_rounds"])

    r_tput = series["resident"][1].rounds / max(series["resident"][3], 1e-9)
    h_tput = series["host_sync"][1].rounds / max(series["host_sync"][3], 1e-9)
    rx, hx = series["resident"][0].pool.xfer, series["host_sync"][0].pool.xfer
    crossed_r = rx["h2d_tokens"] + rx["d2h_tokens"]
    crossed_h = hx["h2d_tokens"] + hx["d2h_tokens"]
    # the boundary-traffic reduction is the trajectory metric beside
    # rounds/s: PCIe traffic is what residency removes
    csv("batched_datapath_device_residency", 0.0,
        f"rounds_ratio={r_tput / max(h_tput, 1e-9):.2f}x "
        f"boundary_tokens_reduction="
        f"{crossed_h / max(crossed_r, 1):.0f}x")


if __name__ == "__main__":
    main()
