"""Throughput and tail latency under chaos vs steady state.

The port's ``benchmarks/bench_chaos_proxy.py``: the same rows,
repetitions, identity checks and gate. It holds the one copy of the
standard scenario (:func:`run_scenario`, :func:`check_identity`), which
``scripts/check_failover_recovery_torch.py`` and chip_smoke.py's phase 10
import. In full mode every worker's stack, header and payload is
:data:`common.DEPLOYMENT`'s.

The fault-tolerance layer's bet: failures should cost recovery work
(bounded retries, one migration, one table recompile), never liveness or
correctness. The bench runs the standard chaos scenario against a
3-worker cluster proxy:

  * 1 backend reset (dead) at t = 25% of the steady-state round count,
    re-routed by the HealthTable + the rule's declared failover backend;
  * 1 worker killed at t = 50% (drain, in-flight flow migration over the
    grant protocol, dead-owner grant copy-out);
  * every live policy table hot-swapped (equivalent rules, epoch bump)
    at t = 75%, under traffic;

and compares delivered msgs/s and P99 quantum latency against the
fault-free run of the identical workload. Every non-dropped message must
be byte-identical to the fault-free run, every loss a counted drop, and
every pool leak-free at shutdown. Gate (as in the reference, in smoke
too): at least 70% of steady-state msgs/s under chaos::

    PYTHONPATH=src python -m benchmarks_torch.bench_chaos_proxy
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from benchmarks_torch.common import DEPLOYMENT, bench_args, csv, is_smoke, \
    record, sync
from repro_torch.core import (
    ClusterRuntime,
    FaultPlan,
    HealthTable,
    LibraCluster,
    PolicyTable,
    build_message,
    eq,
    forward,
    rule,
)

PAGE = 16

#: app metadata starts after the [MAGIC, len_meta, len_payload] header
TAG = 3

N_WORKERS = 3
KILLED_WORKER = 2

#: each worker's pool and pages in the reference's scenario
STACK_KW = dict(n_shards=4, pages_per_shard=2048, page_size=PAGE)


def _table(health=None) -> PolicyTable:
    return PolicyTable([rule(forward(0, failover=1), eq(TAG, 7))],
                       health=health)


def _frames_of(wire) -> list:
    w = np.asarray(wire)
    out, pos = [], 0
    while pos < len(w):
        span = 3 + int(w[pos + 1]) + int(w[pos + 2])
        out.append(tuple(int(x) for x in w[pos:pos + span]))
        pos += span
    return out


def run_scenario(*, chaos: bool, n_chans: int, n_msgs: int, payload: int,
                 steady_rounds: int = 0, seed: int = 0, device="cuda",
                 batch_impl: str = "host", threads: bool = False,
                 meta: int = 4, stack_kw: Optional[dict] = None) -> dict:
    """One full run of the workload; ``chaos=True`` arms the standard
    scenario with event times derived from ``steady_rounds`` (the
    fault-free run's round count; with ``threads``, its epoch count).

    ``batch_impl='host'`` (the default) runs the scalar path, the
    reference's scenario; any other value runs batched rounds of that
    ``batch_impl`` against each worker's resident pool. ``threads`` drives
    the workers as real threads (``run_parallel(threads=True)``) in epochs
    of one round, so fault times stay in rounds. ``meta`` is the header's
    tokens (the tag the rule matches first) and ``stack_kw`` each
    worker's pool (:data:`STACK_KW` by default)."""
    cl = LibraCluster(N_WORKERS, secret=b"chaos-bench", device=device,
                      **(stack_kw or STACK_KW))
    health = HealthTable(2, fail_threshold=2)
    plan = FaultPlan(seed=13)
    rt_kw = ({} if batch_impl == "host"
             else dict(batched=True, batch_impl=batch_impl))
    crt = ClusterRuntime(cl, policy=_table(health), fault_plan=plan, **rt_kw)
    if chaos:
        plan.reset(0, at=max(steady_rounds // 4, 1))
        plan.kill_worker(KILLED_WORKER, at=max(steady_rounds // 2, 2))

        def swap_all(rt):
            for t in rt.policies:
                if t is not None:
                    t.swap([rule(forward(0, failover=1), eq(TAG, 7))])
        plan.at(max(3 * steady_rounds // 4, 3), swap_all)

    rng = np.random.default_rng(seed)
    chans, dst_pairs, sent = [], [], []
    for i in range(n_chans):
        src = cl.socket(worker=i % N_WORKERS)
        pair = [cl.socket(worker=(i + 1) % N_WORKERS) for _ in range(2)]
        chans.append(crt.channel(src, pair))
        dst_pairs.append(pair)
        frames = [build_message(
            np.concatenate([[7], rng.integers(100, 200, meta - 1)]),
            rng.integers(1000, 2000, payload)) for _ in range(n_msgs)]
        sent.append([tuple(int(x) for x in f) for f in frames])
        src.deliver(np.concatenate(frames))

    t0 = time.perf_counter()
    worker_s = None
    if threads:
        _msgs, worker_s = crt.run_parallel(threads=True, epoch_rounds=1)
    else:
        crt.run()
    sync(device)
    dt = time.perf_counter() - t0

    delivered = [sorted(_frames_of(d0.tx_wire()) + _frames_of(d1.tx_wire()))
                 for d0, d1 in dst_pairs]
    drops = sum(c.stats.timeouts + c.stats.drops for c in chans)
    p99s = [s["p99"] for s in crt.latency_summary().values()
            if s.get("count", 0)]
    res = {
        "msgs": crt.messages_forwarded(),
        "dt": dt,
        "worker_s": worker_s,
        "rounds": crt.rounds,
        "drops": drops,
        "retries": sum(c.stats.retries for c in chans),
        "failovers": sum(c.stats.failovers for c in chans),
        # batched rounds re-route in the policy verdict, not on the channel
        "policy_failovers": cl.counters_aggregate().policy_failovers,
        "p99_us": 1e6 * max(p99s) if p99s else 0.0,
        "delivered": delivered,
        "sent": [sorted(s) for s in sent],
        "cluster_stats": dict(cl.stats),
        "fault_summary": plan.summary(),
        "health": health.summary(),
        "xfer": [dict(w.pool.xfer) for w in cl.workers],
        "device_fallbacks": [w.counters.device_fallbacks
                             for w in cl.workers],
    }
    crt.shutdown()          # asserts zero leaked pages/grants on every pool
    return res


def check_identity(chaos: dict, steady: dict) -> None:
    """Every chaos-delivered message is byte-identical to one the steady
    run delivered (exactly once), and every missing one is a counted
    drop."""
    lost = 0
    for got, exp in zip(chaos["delivered"], chaos["sent"]):
        assert len(got) == len(set(got)), "duplicate delivery under chaos"
        assert set(got) <= set(exp), "foreign bytes delivered under chaos"
        lost += len(exp) - len(got)
    assert lost == chaos["drops"], \
        f"{lost - chaos['drops']} messages lost without a counted drop"
    assert steady["drops"] == 0
    for got, exp in zip(steady["delivered"], steady["sent"]):
        assert got == exp


def _pair(n_chans: int, n_msgs: int, payload: int, reps: int,
          device="cuda", **kw):
    """Best-of-k steady + chaos runs of the SAME workload (event times
    pinned to the first steady run's round count), with the identity
    checks chaos must not break."""
    run = dict(n_chans=n_chans, n_msgs=n_msgs, payload=payload,
               device=device, **kw)
    steady = None
    for r in range(reps):
        got = run_scenario(chaos=False, **run)
        if steady is None or got["dt"] < steady["dt"]:
            steady = got
    chaos = None
    for r in range(reps):
        got = run_scenario(chaos=True, steady_rounds=steady["rounds"], **run)
        if chaos is None or got["dt"] < chaos["dt"]:
            chaos = got
    check_identity(chaos, steady)
    assert chaos["cluster_stats"]["worker_kills"] == 1
    assert chaos["failovers"] + chaos["retries"] > 0
    return steady, chaos


def main(argv=None) -> None:
    device = bench_args(argv, __doc__).device
    smoke = is_smoke()
    n_chans = 9 if smoke else 24
    n_msgs = 12 if smoke else 32
    payload = 32 if smoke else DEPLOYMENT.payload
    reps = 2 if smoke else 3
    size = {} if smoke else dict(meta=DEPLOYMENT.meta,
                                 stack_kw=DEPLOYMENT.stack_kw)

    steady, chaos = _pair(n_chans, n_msgs, payload, reps, device=device,
                          **size)
    s_t = steady["msgs"] / max(steady["dt"], 1e-9)
    c_t = chaos["msgs"] / max(chaos["dt"], 1e-9)
    ratio = c_t / max(s_t, 1e-9)
    cs = chaos["cluster_stats"]

    csv("chaos_proxy_steady", 1e6 / max(s_t, 1e-9),
        f"msgs_per_s={s_t:.0f} p99_us={steady['p99_us']:.1f} "
        f"msgs={steady['msgs']} drops={steady['drops']}")
    csv("chaos_proxy_storm", 1e6 / max(c_t, 1e-9),
        f"msgs_per_s={c_t:.0f} p99_us={chaos['p99_us']:.1f} "
        f"msgs={chaos['msgs']} drops={chaos['drops']} "
        f"retries={chaos['retries']} failovers={chaos['failovers']} "
        f"migrated={cs['migrated_flows']} "
        f"dead_grants_copied={cs['dead_grants_copied']}")
    csv("chaos_proxy_recovery_ratio", 0.0,
        f"chaos_over_steady={ratio:.2f}x identity=OK leaks=0")
    record("chaos_proxy_detail", ratio=float(ratio),
           steady_msgs_per_s=float(s_t), chaos_msgs_per_s=float(c_t),
           steady_p99_us=float(steady["p99_us"]),
           chaos_p99_us=float(chaos["p99_us"]),
           drops=int(chaos["drops"]), retries=int(chaos["retries"]),
           failovers=int(chaos["failovers"]),
           migrated_flows=int(cs["migrated_flows"]),
           fault_hits=chaos["fault_summary"]["hits_by_kind"])

    # the acceptance gate -- holds in smoke mode too
    assert ratio >= 0.7, \
        f"recovery throughput {ratio:.2f}x < 0.7x of steady state"


if __name__ == "__main__":
    main()
