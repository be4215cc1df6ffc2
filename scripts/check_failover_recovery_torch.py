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
times, which are in epochs under threads, stay in rounds. The scenario
(``run_scenario``, ``check_identity``) is
``benchmarks_torch/bench_chaos_proxy.py``'s; the script imports only
``repro_torch``, ``benchmarks_torch`` and numpy.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# the scenario's one copy lives in the bench
from benchmarks_torch.bench_chaos_proxy import (  # noqa: E402,F401
    check_identity,
    run_scenario,
)


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
