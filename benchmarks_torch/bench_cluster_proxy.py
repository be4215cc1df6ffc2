"""Multi-worker cluster proxy throughput (the scale-out experiment).

The port's ``benchmarks/bench_cluster_proxy.py``: the same rows, series,
repetitions and gate. In full mode every worker's stack, header and
payload is :data:`common.DEPLOYMENT`'s (a 128 MiB pool a worker). The
cluster runs batched rounds on the host batch path (``batch_impl``
``'host'``, as in the reference), so no kernel runs here; chip_smoke.py's
phase 10 holds the cluster's device path.

1. **Worker scaling** -- the same batched proxy workload on a
   ``LibraCluster`` of W in {1, 2, 4} workers, 0% cross-worker flows,
   reported as the **ideal-parallel wall clock** (``max`` over per-worker
   completion times, ``ClusterRuntime.run_parallel``), then under
   ``run_parallel(threads=True)`` as measured wall time. Gate (as in the
   reference): the threaded 4-worker series at least 1.5x the 1-worker
   series on a host of 4 or more CPUs.
2. **Steering policy** -- consistent-hash vs app-defined (round-robin)
   placement at W=4: balance and its effect on the parallel wall clock.
3. **Cross-worker handoff** -- fraction sweep f in {0, 0.25, 0.5, 1.0} at
   W=2, interleaved scheduling: zero-copy grants vs the one-copy
   ``cross_worker_copied`` fallback, with aggregate CopyCounters equal to
   a single-stack run of the same workload at every fraction::

    PYTHONPATH=src python -m benchmarks_torch.bench_cluster_proxy
"""
from __future__ import annotations

import os
import time

import numpy as np

from benchmarks_torch.common import DEPLOYMENT, bench_args, csv, is_smoke, \
    record, sync
from repro_torch.core import (
    ClusterRuntime,
    LibraCluster,
    LibraStack,
    ProxyRuntime,
    build_message,
)

STACK_KW = dict(n_shards=4, pages_per_shard=1024, page_size=16)


def stack_kw() -> dict:
    """Each worker's pool and pages: the reference's under smoke,
    :data:`common.DEPLOYMENT`'s otherwise."""
    return STACK_KW if is_smoke() else DEPLOYMENT.stack_kw


def _frames(n_chans: int, n_msgs: int, payload: int, seed: int = 0,
            meta: int = 6):
    rng = np.random.default_rng(seed)
    return [[build_message(rng.integers(100, 200, meta),
                           rng.integers(1000, 2000, payload))
             for _ in range(n_msgs)]
            for _ in range(n_chans)]


def _load_cluster(cl, crt, frames, cross_fraction=0.0):
    w = len(cl.workers)
    dsts = []
    for i, chan_frames in enumerate(frames):
        sw = i % w
        dw = (sw + 1) % w if i < cross_fraction * len(frames) else sw
        src = cl.socket(worker=sw)
        dst = cl.socket(worker=dw)
        crt.channel(src, dst, name=f"ch{i}")
        dsts.append(dst)
        for f in chan_frames:
            src.deliver(f)
    return dsts


def _counters_sum(cl):
    agg = cl.counters_aggregate()
    out = {"meta_copied": agg.meta_copied, "full_copied": agg.full_copied,
           "anchored": agg.anchored, "zero_copied": agg.zero_copied,
           "vpi_injected": agg.vpi_injected, "allocs": agg.allocs,
           "crypto_copied": agg.crypto_copied,
           "cross_worker_grants": agg.cross_worker_grants,
           "cross_worker_copied": agg.cross_worker_copied}
    return out


def _paired_cluster(workers: int, frames, device, **steer_kw):
    """A cluster of ``workers`` with one flow a channel (``socket_pair``,
    steered by ``steer_kw``; app round-robin by default) loaded with
    ``frames``, under a batched runtime without work stealing."""
    steer_kw = steer_kw or dict(steering="app",
                                app_fn=lambda flow, n: flow[1] % n)
    cl = LibraCluster(workers, secret=b"bench", device=device, **steer_kw,
                      **stack_kw())
    crt = ClusterRuntime(cl, batched=True, work_stealing=False)
    for i, chan_frames in enumerate(frames):
        src, dst = cl.socket_pair(flow=("ch", i))
        crt.channel(src, dst, name=f"ch{i}")
        for f in chan_frames:
            src.deliver(f)
    return cl, crt


def scaling_run(workers: int, frames, device, threads: bool = False):
    """One run of series 1 (``threads=False``: ideal-parallel) or 1b:
    ``(seconds, per-worker seconds, messages, cluster)``; the seconds are
    the ideal-parallel ``max`` or, under threads, the measured wall."""
    cl, crt = _paired_cluster(workers, frames, device)
    t0 = time.perf_counter()
    msgs, times = crt.run_parallel(threads=threads)
    sync(device)
    dt = time.perf_counter() - t0
    crt.shutdown()
    return (dt if threads else max(times)), times, msgs, cl


def steering_run(steer_kw: dict, frames, device):
    """One run of series 2: ``(ideal-parallel seconds, messages,
    cluster)``."""
    cl, crt = _paired_cluster(4, frames, device, **steer_kw)
    msgs, times = crt.run_parallel()
    sync(device)
    crt.shutdown()
    return max(times), msgs, cl


def single_stack_snapshot(frames, device):
    """The CopyCounters snapshot of one ``LibraStack`` serving
    ``frames``: what every fraction of series 3 must equal."""
    stack = LibraStack(secret=b"bench", device=device, **stack_kw())
    rt = ProxyRuntime(stack, batched=True)
    for i, chan_frames in enumerate(frames):
        src, dst = stack.socket_pair()
        rt.channel(src, dst, name=f"ch{i}")
        for f in chan_frames:
            src.deliver(f)
    rt.run()
    snap = stack.counters.snapshot()
    rt.shutdown()
    return snap


def handoff_run(frac: float, frames, single_snap, device):
    """One run of series 3 at cross fraction ``frac``: ``(seconds,
    messages, cluster, counters equal to the single stack's)``."""
    cl = LibraCluster(2, secret=b"bench", device=device, **stack_kw())
    crt = ClusterRuntime(cl, batched=True)
    _load_cluster(cl, crt, frames, cross_fraction=frac)
    t0 = time.perf_counter()
    msgs = crt.run()
    sync(device)
    dt = time.perf_counter() - t0
    identical = cl.counters_aggregate().snapshot() == single_snap
    crt.shutdown()
    return dt, msgs, cl, identical


def main(argv=None) -> None:
    device = bench_args(argv, __doc__).device
    smoke = is_smoke()
    n_chans = 24 if smoke else 96
    n_msgs = 4 if smoke else 12
    payload = 64 if smoke else DEPLOYMENT.payload
    meta = 6 if smoke else DEPLOYMENT.meta
    reps = 2 if smoke else 3
    total_msgs = n_chans * n_msgs

    # -- 1. worker scaling (batched, 0% cross-worker, ideal-parallel) -------
    frames = _frames(n_chans, n_msgs, payload, meta=meta)
    base_tput = None
    for workers in (1, 2, 4):
        best = None
        for r in range(reps):
            got = scaling_run(workers, frames, device)
            if best is None or got[0] < best[0]:
                best = got
        wall, times, msgs, cl = best
        assert msgs == total_msgs, (msgs, total_msgs)
        tput = msgs / max(wall, 1e-9)
        if workers == 1:
            base_tput = tput
        speedup = tput / max(base_tput, 1e-9)
        csv(f"cluster_proxy_w{workers}_batched", 1e6 / max(tput, 1e-9),
            f"msgs_per_s={tput:.0f} ideal_parallel_wall_us={wall * 1e6:.0f} "
            f"speedup_vs_1w={speedup:.2f}x "
            f"worker_walls_us={'/'.join(f'{t * 1e6:.0f}' for t in times)}")
        record(f"cluster_proxy_w{workers}_batched_counters",
               workers=workers, msgs_per_s=tput, speedup_vs_1w=speedup,
               steering="app", cross_fraction=0.0, **_counters_sum(cl))

    # -- 1b. threaded executor: REAL wall clock, W in {1, 2, 4} --------------
    # run_parallel(threads=True) drives one OS thread per worker. On a
    # multi-core host the 4-worker series is expected >= 1.5x the 1-worker
    # series (the reference's gate, asserted when the host has the cores);
    # round assembly is Python that holds the GIL
    n_cpus = os.cpu_count() or 1
    base_real = None
    for workers in (1, 2, 4):
        best = None
        for _ in range(reps):
            got = scaling_run(workers, frames, device, threads=True)
            if best is None or got[0] < best[0]:
                best = got
        dt, times, msgs, cl = best
        ideal = max(times)
        assert msgs == total_msgs, (msgs, total_msgs)
        tput = msgs / max(dt, 1e-9)
        if workers == 1:
            base_real = tput
        speedup = tput / max(base_real, 1e-9)
        csv(f"cluster_proxy_w{workers}_threads", 1e6 / max(tput, 1e-9),
            f"msgs_per_s={tput:.0f} real_wall_us={dt * 1e6:.0f} "
            f"ideal_parallel_wall_us={ideal * 1e6:.0f} "
            f"speedup_vs_1w={speedup:.2f}x cpus={n_cpus}")
        record(f"cluster_proxy_w{workers}_threads_counters",
               workers=workers, msgs_per_s=tput, speedup_vs_1w=speedup,
               real_wall_s=dt, ideal_parallel_wall_s=ideal,
               cpu_count=n_cpus, threads=True, **_counters_sum(cl))
        if workers == 4 and n_cpus >= 4:
            assert speedup >= 1.5, \
                f"threaded 4-worker speedup {speedup:.2f}x < 1.5x on " \
                f"a {n_cpus}-CPU host"

    # -- 2. steering: consistent hash vs app-defined at W=4 ------------------
    for steer_name, steer_kw in (
            ("hash", dict(steering="hash")),
            ("app_rr", dict(steering="app",
                            app_fn=lambda flow, n: flow[1] % n))):
        best = None
        for _ in range(reps):
            got = steering_run(steer_kw, frames, device)
            if best is None or got[0] < best[0]:
                best = got
        wall, msgs, cl = best
        share = cl.steering.stats["per_worker"]
        tput = msgs / max(wall, 1e-9)
        csv(f"cluster_proxy_steering_{steer_name}", 1e6 / max(tput, 1e-9),
            f"msgs_per_s={tput:.0f} per_worker_flows={'/'.join(map(str, share))} "
            f"imbalance={max(share) / max(sum(share) / len(share), 1e-9):.2f}")
        record(f"cluster_proxy_steering_{steer_name}_counters",
               workers=4, msgs_per_s=tput, steering=steer_name,
               per_worker_flows=list(share), **_counters_sum(cl))

    # -- 3. cross-worker fraction sweep at W=2 (interleaved, with identity) --
    single_snap = single_stack_snapshot(frames, device)
    for frac in (0.0, 0.25, 0.5, 1.0):
        best = None
        for _ in range(reps):
            got = handoff_run(frac, frames, single_snap, device)
            if best is None or got[0] < best[0]:
                best = got
        dt, msgs, cl, identical = best
        tput = msgs / max(dt, 1e-9)
        csv(f"cluster_proxy_cross_{int(frac * 100)}pct",
            1e6 / max(tput, 1e-9),
            f"msgs_per_s={tput:.0f} grants={cl.stats['grants']} "
            f"copies={cl.stats['copies']} "
            f"counters_match_single_stack={identical}")
        record(f"cluster_proxy_cross_{int(frac * 100)}pct_counters",
               workers=2, cross_fraction=frac, msgs_per_s=tput,
               counters_match_single_stack=bool(identical),
               grants=cl.stats["grants"], copies=cl.stats["copies"],
               **_counters_sum(cl))


if __name__ == "__main__":
    main()
