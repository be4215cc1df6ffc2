"""Failover-recovery invariants of the PyTorch port's fault-tolerance layer.

Runs the standard chaos scenario against a 3-worker ``repro_torch``
cluster proxy (backend reset at t=25%, worker kill at t=50%, policy table
hot-swap at t=75%, times pinned to the fault-free run's round count) at a
small fixed size and asserts, deterministically (seeded ``FaultPlan``, no
wall-clock thresholds):

1. **Identity**: every message delivered under chaos is byte-identical to
   one the fault-free run delivered, exactly once; every missing message
   is a counted drop (no silent loss).
2. **Recovery machinery engaged**: the breaker/failover path or the retry
   loop fired, one worker was killed and its live flows migrated.
3. **Zero leaks**: every pool drains to fully free with no grant pins
   outstanding (asserted inside ``ClusterRuntime.shutdown``).

Run on the card::

    PYTHONPATH=src python scripts/check_failover_recovery_torch.py

or on the CPU with ``--device cpu``. ``--batch-impl host`` (the default)
runs the scalar path, the scenario of ``scripts/check_failover_recovery.py``;
any other value (``fused-round``, ``auto``, ``ref``, ...) runs batched
rounds of that ``batch_impl`` against each worker's resident pool.
``run_scenario(threads=True)`` drives the workers as real threads
(``run_parallel(threads=True)``) in epochs of one round, so that fault
times, which are in epochs under threads, stay in rounds. The script
imports only ``repro_torch`` and numpy.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (  # noqa: E402
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
                 batch_impl: str = "host", threads: bool = False) -> dict:
    """One full run of the workload; ``chaos=True`` arms the standard
    scenario with event times derived from ``steady_rounds`` (the
    fault-free run's round count; with ``threads``, its epoch count)."""
    cl = LibraCluster(N_WORKERS, n_shards=4, pages_per_shard=2048,
                      page_size=PAGE, secret=b"chaos-bench", device=device)
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
            np.concatenate([[7], rng.integers(100, 200, 3)]),
            rng.integers(1000, 2000, payload)) for _ in range(n_msgs)]
        sent.append([tuple(int(x) for x in f) for f in frames])
        src.deliver(np.concatenate(frames))

    t0 = time.perf_counter()
    worker_s = None
    if threads:
        _msgs, worker_s = crt.run_parallel(threads=True, epoch_rounds=1)
    else:
        crt.run()
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


def check_recovery(chaos: dict, n_chans: int, n_msgs: int,
                   threads: bool = False) -> None:
    """The recovery machinery fired: one kill, a migrated flow, the retry
    loop or the failover path (a held send re-routed on the channel, or a
    verdict re-routed by the policy table in a batched round), and every
    message delivered or dropped.

    Under ``threads`` the workers share one ``HealthTable`` whose count of
    consecutive failures any worker's successful send resets, so whether
    the breaker trips, and so whether anything fails over, depends on how
    the threads interleave. There the check is that the breaker saw the
    reset backend's failures."""
    cs = chaos["cluster_stats"]
    assert cs["worker_kills"] == 1, "the worker kill never fired"
    assert cs["migrated_flows"] >= 1, "no live flow migrated off the worker"
    if threads:
        assert chaos["health"]["failures"] > 0, \
            "the breaker never saw the reset backend fail"
    else:
        assert (chaos["failovers"] + chaos["policy_failovers"]
                + chaos["retries"]) > 0, \
            "neither the retry loop nor the failover path engaged"
    assert chaos["msgs"] + chaos["drops"] == n_chans * n_msgs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch-impl", default="host")
    args = ap.parse_args(argv)
    n_chans, n_msgs, payload = 9, 12, 32
    kw = dict(n_chans=n_chans, n_msgs=n_msgs, payload=payload,
              device=args.device, batch_impl=args.batch_impl)
    steady = run_scenario(chaos=False, **kw)
    assert steady["drops"] == 0 and steady["msgs"] == n_chans * n_msgs
    print(f"steady:  msgs={steady['msgs']} rounds={steady['rounds']} "
          f"drops=0")

    chaos = run_scenario(chaos=True, steady_rounds=steady["rounds"], **kw)
    check_identity(chaos, steady)
    check_recovery(chaos, n_chans, n_msgs)
    cs = chaos["cluster_stats"]
    print(f"chaos:   msgs={chaos['msgs']} drops={chaos['drops']} "
          f"retries={chaos['retries']} failovers={chaos['failovers']} "
          f"policy_failovers={chaos['policy_failovers']} "
          f"migrated={cs['migrated_flows']} "
          f"fault_hits={chaos['fault_summary']['hits_by_kind']}")
    print("failover recovery: OK (identity + conservation + zero leaks)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
