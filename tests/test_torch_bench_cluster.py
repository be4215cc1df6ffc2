"""The port's cluster and chaos benches against the JAX package's, on the
CPU at the smoke sizes.

The reference's ``main()`` of either bench cannot finish on a host with
cores (its threaded 4-worker gate and its recovery gate are wall-clock
gates), so their parts are twinned instead: ``_frames``,
``_load_cluster`` and ``_counters_sum``, one run of each series (the
ideal-parallel and threaded W sweep, steering, the cross-worker handoff
sweep and its single-stack snapshot) against the same steps through
``repro.core``, and the chaos scenario of
``benchmarks/bench_chaos_proxy.py``. What a run forwarded, counted and
granted must be equal; no time is compared and no gate is switched off.
"""
import numpy as np
import pytest

import repro.core as jcore
from benchmarks import bench_chaos_proxy as jchaos
from benchmarks import bench_cluster_proxy as jbench
from benchmarks_torch import bench_chaos_proxy as tchaos
from benchmarks_torch import bench_cluster_proxy as tbench

#: the reference's smoke workload
N_CHANS, N_MSGS, PAYLOAD = 24, 4, 64


@pytest.fixture(autouse=True)
def _smoke(monkeypatch):
    monkeypatch.setenv("LIBRA_BENCH_SMOKE", "1")


@pytest.fixture
def frames():
    return tbench._frames(N_CHANS, N_MSGS, PAYLOAD)


def test_frames_are_the_references(frames):
    ref = jbench._frames(N_CHANS, N_MSGS, PAYLOAD)
    assert len(frames) == len(ref)
    for got, want in zip(frames, ref):
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert tbench.stack_kw() == jbench.STACK_KW


def _jax_paired(workers, frames, **steer_kw):
    """The reference's series 1 and 2 set-up, through ``repro.core``."""
    steer_kw = steer_kw or dict(steering="app",
                                app_fn=lambda flow, n: flow[1] % n)
    cl = jcore.LibraCluster(workers, secret=b"bench", **steer_kw,
                            **jbench.STACK_KW)
    crt = jcore.ClusterRuntime(cl, batched=True, work_stealing=False)
    for i, chan_frames in enumerate(frames):
        src, dst = cl.socket_pair(flow=("ch", i))
        crt.channel(src, dst, name=f"ch{i}")
        for f in chan_frames:
            src.deliver(f)
    return cl, crt


@pytest.mark.parametrize("threads", [False, True], ids=["ideal", "threads"])
@pytest.mark.parametrize("workers", [1, 2, 4])
def test_worker_scaling_series(workers, threads, frames):
    _s, times, msgs, cl = tbench.scaling_run(workers, frames, "cpu",
                                             threads=threads)
    jcl, jcrt = _jax_paired(workers, frames)
    jmsgs, jtimes = jcrt.run_parallel(threads=threads)
    jcrt.shutdown()
    assert msgs == jmsgs == N_CHANS * N_MSGS
    assert len(times) == len(jtimes) == workers
    assert tbench._counters_sum(cl) == jbench._counters_sum(jcl)
    assert cl.counters_aggregate().snapshot() \
        == jcl.counters_aggregate().snapshot()


@pytest.mark.parametrize("steer", ["hash", "app_rr"])
def test_steering_series(steer, frames):
    kw = (dict(steering="hash") if steer == "hash" else
          dict(steering="app", app_fn=lambda flow, n: flow[1] % n))
    _s, msgs, cl = tbench.steering_run(kw, frames, "cpu")
    jcl, jcrt = _jax_paired(4, frames, **kw)
    jmsgs, _t = jcrt.run_parallel()
    jcrt.shutdown()
    assert msgs == jmsgs
    assert cl.steering.stats["per_worker"] == jcl.steering.stats["per_worker"]
    assert tbench._counters_sum(cl) == jbench._counters_sum(jcl)


def _jax_single_snapshot(frames):
    stack = jcore.LibraStack(secret=b"bench", **jbench.STACK_KW)
    rt = jcore.ProxyRuntime(stack, batched=True)
    for i, chan_frames in enumerate(frames):
        src, dst = stack.socket_pair()
        rt.channel(src, dst, name=f"ch{i}")
        for f in chan_frames:
            src.deliver(f)
    rt.run()
    snap = stack.counters.snapshot()
    rt.shutdown()
    return snap


@pytest.mark.parametrize("frac", [0.0, 0.25, 0.5, 1.0])
def test_cross_worker_handoff_series(frac, frames):
    snap = tbench.single_stack_snapshot(frames, "cpu")
    jsnap = _jax_single_snapshot(frames)
    assert snap == jsnap
    _dt, msgs, cl, identical = tbench.handoff_run(frac, frames, snap, "cpu")
    jcl = jcore.LibraCluster(2, secret=b"bench", **jbench.STACK_KW)
    jcrt = jcore.ClusterRuntime(jcl, batched=True)
    jbench._load_cluster(jcl, jcrt, frames, cross_fraction=frac)
    jmsgs = jcrt.run()
    jidentical = jcl.counters_aggregate().snapshot() == jsnap
    jcrt.shutdown()
    assert (msgs, identical) == (jmsgs, jidentical)
    assert identical
    assert (cl.stats["grants"], cl.stats["copies"]) \
        == (jcl.stats["grants"], jcl.stats["copies"])
    assert tbench._counters_sum(cl) == jbench._counters_sum(jcl)
    if frac:
        assert cl.stats["grants"] > 0


SCENARIO_KEYS = ("msgs", "rounds", "drops", "retries", "failovers",
                 "p99_us", "delivered", "sent", "cluster_stats",
                 "fault_summary")


@pytest.mark.parametrize("chaos", [False, True], ids=["steady", "chaos"])
def test_chaos_scenario_is_the_references(chaos):
    """The bench's one copy of the scenario at the reference's smoke size
    (9 channels x 12 messages x 32 tokens): the same frames, drops, stats
    and fault summary as ``benchmarks/bench_chaos_proxy.py``'s."""
    size = dict(n_chans=9, n_msgs=12, payload=32)
    jsteady = jchaos.run_scenario(chaos=False, **size)
    tsteady = tchaos.run_scenario(chaos=False, device="cpu", **size)
    j, t = jsteady, tsteady
    if chaos:
        j = jchaos.run_scenario(chaos=True, steady_rounds=jsteady["rounds"],
                                **size)
        t = tchaos.run_scenario(chaos=True, steady_rounds=tsteady["rounds"],
                                device="cpu", **size)
        tchaos.check_identity(t, tsteady)
    keys = [k for k in SCENARIO_KEYS if k != "p99_us"]
    assert {k: t[k] for k in keys} == {k: j[k] for k in keys}


def test_chaos_pair_holds_its_checks():
    """``_pair`` (best of k steady and chaos runs, identity, one kill, the
    recovery path engaged) at the smoke size, and at a deployment-shaped
    header and page on a small pool."""
    steady, chaos = tchaos._pair(9, 12, 32, 1, device="cpu")
    assert chaos["cluster_stats"]["worker_kills"] == 1
    steady, chaos = tchaos._pair(
        9, 12, 2048, 1, device="cpu", meta=128,
        stack_kw=dict(n_shards=4, pages_per_shard=64, page_size=1024))
    assert chaos["msgs"] + chaos["drops"] == 9 * 12
    assert steady["delivered"] == steady["sent"]


def test_the_failover_script_runs_the_benchs_scenario():
    import importlib.util

    path = tbench.__file__.replace(
        "benchmarks_torch/bench_cluster_proxy.py",
        "scripts/check_failover_recovery_torch.py")
    spec = importlib.util.spec_from_file_location("failover_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.run_scenario is tchaos.run_scenario
    assert mod.check_identity is tchaos.check_identity
