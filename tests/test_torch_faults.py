"""Twins of ``tests/test_faults.py``, the chaos matrix on the device plane,
and the port's failover-recovery script against the JAX scenario.

Each test of the JAX package's fault file (every parametrised case) runs
through ``repro.core`` and through the port's ``repro_torch.core``
(``device="cpu"``) on the same seeds (``tests/_twin.py``): its own
assertions hold on both sides, and wire bytes, ``CopyCounters``,
``cluster.stats``, ``FaultPlan.summary()`` and ``log``, and channel stats
are identical. The threaded chaos test is twinned below without its
``LocksetMonitor`` check: the JAX package's ``analysis`` is not ported.
"""
import dataclasses
import importlib.util

import numpy as np
import pytest

import _twin
import repro.core as jcore
import repro_torch.core as tcore
from benchmarks import bench_chaos_proxy

PATH = _twin.TESTS / "test_faults.py"
SCRIPT = _twin.TESTS.parent / "scripts" / "check_failover_recovery_torch.py"
THREADED = "test_threaded_chaos_conservation_and_clean_lockset"
#: re-runs its scenario while the throughput ratio misses, so how many
#: runs it makes depends on the wall clock: twinned below on one run each
STANDARD = "test_standard_chaos_scenario_identity_and_recovery_throughput"

PKGS = {"jax": (jcore, {}), "torch": (tcore, {"device": "cpu"})}
#: the port's batch_impl -> the one the JAX side runs on the CPU
JAX_IMPL = {"ref": "ref", "fused-round:ref": "fused-round:ref",
            "auto": "auto", "fused-round": "fused-round:ref"}
STACK_KW = dict(n_shards=4, pages_per_shard=128, page_size=16)
TAG = 3     # app metadata starts after the [MAGIC, len_meta, len_payload]


@pytest.mark.parametrize("case",
                         _twin.cases(PATH, skip=(THREADED, STANDARD)),
                         ids=_twin.case_id)
def test_faults_twin(case):
    name, params = case
    _twin.run(PATH, name, **params)


def test_standard_chaos_scenario_twin():
    """The standard scenario's fault-free and chaos runs give the same
    delivered frames, drops and messages, and leave every object they
    built the same, in both packages; then the test itself, throughput
    ratio included, passes on the port."""
    _twin.sync_connection_ids()
    got = {}
    for pkg in _twin.PKGS:
        mod = _twin.load(PATH, pkg)
        runs = []

        def scenario():
            for chaos in (False, True):
                delivered, drops, _dt, msgs, sent = mod._run_scenario(chaos)
                runs.append((delivered, drops, msgs, sent))
        got[pkg] = (_twin.observed(pkg, scenario), runs)
    assert got["torch"] == got["jax"]
    getattr(_twin.load(PATH, "torch"), STANDARD)()


def _deliver(core, src, n, seed=0, tag=7, payload=24, tls=False):
    rng = np.random.default_rng(seed)
    frames = [core.build_message(
        np.concatenate([[tag], rng.integers(100, 200, 3)]),
        rng.integers(1000, 2000, payload)) for _ in range(n)]
    src.deliver(src.tls.seal_frames(frames, src.parser.inner) if tls
                else np.concatenate(frames))
    return frames


def _frames_of(wire):
    w = np.asarray(wire)
    out, pos = [], 0
    while pos < len(w):
        span = 3 + int(w[pos + 1]) + int(w[pos + 2])
        out.append(tuple(int(x) for x in w[pos:pos + span]))
        pos += span
    return out


def _threaded_chaos(pkg):
    """The JAX package's threaded chaos test without its lockset check:
    backend reset at 25 %, worker kill at 50 %, policy hot-swap at 75 % of
    the epoch budget, driven by real worker threads."""
    core, kw = PKGS[pkg]
    epochs = 8
    cl = core.LibraCluster(3, secret=b"chaos", **STACK_KW, **kw)
    health = core.HealthTable(2, fail_threshold=2)
    plan = core.FaultPlan(seed=13)
    table = core.PolicyTable(
        [core.rule(core.forward(0, failover=1), core.eq(TAG, 7))],
        health=health)
    crt = core.ClusterRuntime(cl, policy=table, fault_plan=plan)
    plan.reset(0, at=epochs // 4)
    plan.kill_worker(2, at=epochs // 2)

    def swap_all(rt):
        for t in rt.policies:
            if t is not None:
                t.swap([core.rule(core.forward(0, failover=1),
                                  core.eq(TAG, 7))])
    plan.at(3 * epochs // 4, swap_all)

    chans, dst_pairs, sent = [], [], []
    for i in range(6):
        src = cl.socket(worker=i % 3)
        pair = [cl.socket(worker=(i + 1) % 3) for _ in range(2)]
        chans.append(crt.channel(src, pair, name=f"ch{i}"))
        dst_pairs.append(pair)
        sent.append(_deliver(core, src, 4, seed=300 + i))
    _msgs, times = crt.run_parallel(threads=True, epoch_rounds=64)
    assert cl.stats["worker_kills"] == 1
    assert all(t.epoch == 1 for t in crt.policies if t is not None)
    assert len(times) == 3 and all(t >= 0 for t in times)
    delivered = []
    for i, (d0, d1) in enumerate(dst_pairs):
        got = sorted(_frames_of(d0.tx_wire()) + _frames_of(d1.tx_wire()))
        exp = sorted(tuple(int(x) for x in f) for f in sent[i])
        assert len(got) == len(set(got))
        assert set(got) <= set(exp), f"channel {i} delivered foreign bytes"
        drops = chans[i].stats.timeouts + chans[i].stats.drops
        assert len(got) + drops == len(exp), \
            f"channel {i}: {len(exp) - len(got) - drops} uncounted losses"
        delivered.append(got)
    out = dict(delivered=delivered, log=list(plan.log),
               stats=dict(cl.stats), summary=plan.summary())
    crt.shutdown()         # asserts zero leaked pages/grants on every pool
    return out


def test_threaded_chaos_conservation_twin():
    """Conservation, the kill, the swap and zero leaks on both packages,
    and the same fired events. Which frames arrive may depend on how the
    threads interleave with the shared health table, so it is held by
    conservation, not compared."""
    j = _threaded_chaos("jax")
    t = _threaded_chaos("torch")
    assert t["log"] == j["log"]
    assert t["summary"] == j["summary"]
    assert t["stats"]["worker_kills"] == j["stats"]["worker_kills"] == 1


# ---------------------------------------------------------------------------
# the chaos matrix on the device plane
# ---------------------------------------------------------------------------

@pytest.fixture()
def _jax_gathers_every_round_on_device(monkeypatch):
    monkeypatch.setattr(f"{jcore.__name__}.stack._SMALL_GATHER_ROWS", 0)


def _storm_run(pkg, impl, tls, executor, faulty):
    """The chaos matrix's cluster cell (a finite EAGAIN storm on backend
    0), batched at ``impl``; under threads the plan ticks once an epoch
    of one round."""
    core, kw = PKGS[pkg]
    plan = (core.FaultPlan(seed=7).eagain(0, start=1, until=5, p=0.7)
            if faulty else None)
    cl = core.LibraCluster(2, secret=b"ft", **STACK_KW, **kw)
    crt = core.ClusterRuntime(
        cl, batched=True, fault_plan=plan,
        batch_impl=JAX_IMPL[impl] if pkg == "jax" else impl)
    chans, dsts = [], []
    for i in range(4):
        src = cl.socket("length-prefixed", worker=i % 2, tls=tls)
        dst = cl.socket("length-prefixed", worker=(i + 1) % 2, tls=tls)
        chans.append(crt.channel(src, dst, name=f"ch{i}"))
        dsts.append(dst)
        _deliver(core, src, 4, seed=100 + i, tls=tls is not None)
    if executor == "threads":
        crt.run_parallel(threads=True, epoch_rounds=1)
    else:
        crt.run()
    agg = cl.counters_aggregate()
    out = dict(
        wires=[(d.tls.open_wire(d.tx_wire()) if tls
                else d.tx_wire()).tolist() for d in dsts],
        snap=agg.snapshot(), counters=dataclasses.asdict(agg),
        retries=sum(c.stats.retries for c in chans),
        channels=[(c.stats.messages, c.stats.retries, c.stats.timeouts)
                  for c in chans],
        log=[] if plan is None else list(plan.log),
        summary=None if plan is None else plan.summary(),
        device_rounds=[w.pool.xfer["device_rounds"] for w in cl.workers],
        host_gathers=[w.pool.xfer.get("host_gathers", 0)
                      for w in cl.workers])
    crt.shutdown()
    assert cl.pages_in_use == 0
    return out


@pytest.mark.usefixtures("_jax_gathers_every_round_on_device")
@pytest.mark.parametrize("executor", ["run", "threads"])
@pytest.mark.parametrize("tls", [None, "hw"], ids=["plain", "hw"])
@pytest.mark.parametrize("impl", list(JAX_IMPL))
def test_device_plane_chaos_storm_matches_jax(impl, tls, executor):
    j = _storm_run("jax", impl, tls, executor, True)
    t = _storm_run("torch", impl, tls, executor, True)
    assert t == j
    assert t["retries"] > 0, "the storm never bit"
    assert all(n > 0 for n in t["device_rounds"])
    assert t["host_gathers"] == [0, 0]
    assert t["counters"]["device_fallbacks"] == 0
    ref = _storm_run("torch", impl, tls, executor, False)
    assert t["snap"] == ref["snap"] and t["wires"] == ref["wires"]


# ---------------------------------------------------------------------------
# the failover-recovery script against the JAX scenario
# ---------------------------------------------------------------------------

def _script():
    spec = importlib.util.spec_from_file_location("_failover_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCENARIO_KEYS = ("msgs", "rounds", "drops", "retries", "failovers",
                 "delivered", "sent", "cluster_stats", "fault_summary")


def test_failover_script_matches_the_jax_scenario():
    """``scripts/check_failover_recovery_torch.py --device cpu`` at the JAX
    script's size (9 channels x 12 messages x 32 tokens, the scalar
    path) delivers the frames, drops, cluster stats and fault summary of
    ``benchmarks.bench_chaos_proxy.run_scenario``, fault-free and under
    chaos."""
    mod = _script()
    size = dict(n_chans=9, n_msgs=12, payload=32)
    j_steady = bench_chaos_proxy.run_scenario(chaos=False, **size)
    t_steady = mod.run_scenario(chaos=False, device="cpu", **size)
    j_chaos = bench_chaos_proxy.run_scenario(
        chaos=True, steady_rounds=j_steady["rounds"], **size)
    t_chaos = mod.run_scenario(chaos=True, device="cpu",
                               steady_rounds=t_steady["rounds"], **size)
    for j, t in ((j_steady, t_steady), (j_chaos, t_chaos)):
        assert {k: t[k] for k in SCENARIO_KEYS} \
            == {k: j[k] for k in SCENARIO_KEYS}
    mod.check_identity(t_chaos, t_steady)
    mod.check_recovery(t_chaos, size["n_chans"], size["n_msgs"])
    assert mod.main(["--device", "cpu"]) == 0


@pytest.mark.parametrize("threads", [False, True], ids=["run", "threads"])
@pytest.mark.parametrize("impl", ["fused-round", "auto"])
def test_failover_script_on_the_device_plane(impl, threads):
    """The scenario as ``chip_smoke.py`` runs it on the card: batched
    rounds against each worker's resident pool, emulated and threaded."""
    mod = _script()
    if not threads:
        assert mod.main(["--device", "cpu", "--batch-impl", impl]) == 0
    size = dict(n_chans=9, n_msgs=12, payload=32)
    kw = dict(size, device="cpu", batch_impl=impl, threads=threads)
    steady = mod.run_scenario(chaos=False, **kw)
    chaos = mod.run_scenario(chaos=True, steady_rounds=steady["rounds"],
                             **kw)
    mod.check_identity(chaos, steady)
    mod.check_recovery(chaos, size["n_chans"], size["n_msgs"],
                       threads=threads)
