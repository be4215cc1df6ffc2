"""Twins of ``tests/test_cluster.py``, and the cluster on the device plane.

Each test of the JAX package's cluster file (every parametrised case) runs
through ``repro.core`` and through the port's ``repro_torch.core``
(``device="cpu"``) on the same seeds (``tests/_twin.py``): its own
assertions hold on both sides, and wire bytes, ``CopyCounters``,
``cluster.stats`` and channel stats are identical.

The JAX tests run ``ProxyRuntime``'s default ``batch_impl="host"``, so
they never put a cluster's pools on the device plane. The cases below do:
the cross-worker identity, the watermark fallback, kill-migration and the
dead-owner copy-out run batched rounds at ``batch_impl`` ``ref``,
``fused-round:ref``, ``auto`` and ``fused-round`` (the JAX side runs
``fused-round:ref`` for the port's ``fused-round``), emulated and with
``run_parallel(threads=True)``, and must equal the JAX package's run and
the host path's.
"""
import collections
import dataclasses
import threading

import numpy as np
import pytest
import torch

import _twin
import repro.core as jcore
import repro_torch.core as tcore
from repro.core.crypto import REC_HEADER
from repro.core.policy import payload_at as j_payload_at
from repro_torch.core.device_pool import DevicePool
from repro_torch.core.policy import payload_at as t_payload_at

PATH = _twin.TESTS / "test_cluster.py"

PKGS = {"jax": (jcore, j_payload_at, {}),
        "torch": (tcore, t_payload_at, {"device": "cpu"})}
#: the port's batch_impl -> the one the JAX side runs on the CPU
JAX_IMPL = {"ref": "ref", "fused-round:ref": "fused-round:ref",
            "auto": "auto", "fused-round": "fused-round:ref"}
IMPLS = list(JAX_IMPL)
STACK_KW = dict(n_shards=4, pages_per_shard=128, page_size=16)
TAG = 3     # app metadata starts after the [MAGIC, len_meta, len_payload]


@pytest.mark.parametrize("case", _twin.cases(PATH), ids=_twin.case_id)
def test_cluster_twin(case):
    name, params = case
    _twin.run(PATH, name, **params)


# ---------------------------------------------------------------------------
# the cluster on the device plane
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def _jax_gathers_every_round_on_device(monkeypatch):
    """The JAX package serves batched gathers of up to four rows on the
    host (``_SMALL_GATHER_ROWS``); the port gathers every device-plane
    round on the device. Setting the threshold to 0 makes the two count
    the same ``xfer``."""
    monkeypatch.setattr(f"{jcore.__name__}.stack._SMALL_GATHER_ROWS", 0)


def _impl(pkg, impl):
    return JAX_IMPL[impl] if pkg == "jax" else impl


def _table(core, payload_at, tls):
    """``chip_smoke.py``'s table: a metadata drop, a payload-prefix
    forward and a metadata forward."""
    off = (REC_HEADER if tls else 0) + TAG
    return core.PolicyTable([
        core.rule(core.drop(), core.between(off, 196, 199)),
        core.rule(core.forward(1), payload_at(0, 1950, 2000)),
        core.rule(core.forward(0), core.between(off, 100, 199)),
    ])


def _frames(core, n_chans, n_msgs, seed=5):
    """Tags and first payload tokens drawn so every rule gets hits."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_chans):
        chan = []
        for _ in range(n_msgs):
            meta = np.concatenate([[rng.choice([120, 150, 197])],
                                   rng.integers(100, 200, 3)])
            payload = rng.integers(1000, 2000, int(rng.integers(9, 40)))
            payload[0] = rng.choice([1500, 1975])
            chan.append(core.build_message(meta, payload))
        out.append(chan)
    return out


def _load(src, frames, tls):
    src.deliver(src.tls.seal_frames(frames, src.parser.inner) if tls
                else np.concatenate(frames))


def _wires(dsts, tls):
    return [(d.tls.open_wire(d.tx_wire()) if tls else d.tx_wire()).tolist()
            for d in dsts]


def _drive(crt, executor):
    if executor == "run":
        crt.run()
        return
    _msgs, times = crt.run_parallel(threads=executor == "threads")
    assert len(times) == len(crt.runtimes) and all(t >= 0 for t in times)


def _xfer(pool):
    x = dict(pool.xfer)
    x.pop("donated_rounds")
    x.pop("host_gathers", None)
    return x


def _device_plane_ok(cl, impl, counters):
    """Every live worker ran device rounds, none served on the host."""
    if impl == "host":
        return
    assert counters["device_fallbacks"] == 0
    for i, w in enumerate(cl.workers):
        if i in cl.dead_workers:
            continue
        x = w.pool.xfer
        assert x["device_rounds"] > 0, (i, x)
        assert x["pool_syncs"] == 0 and x.get("host_gathers", 0) == 0, (i, x)


def _cluster_run(pkg, impl, executor, tls, *, n_workers=3, n_chans=9,
                 n_msgs=4, cross=4):
    """Channel i's source is on worker i % W; both destinations are on the
    next worker for the first ``cross`` channels, on the source's own
    worker otherwise."""
    core, payload_at, kw = PKGS[pkg]
    cl = core.LibraCluster(n_workers, secret=b"cl", **STACK_KW, **kw)
    table = _table(core, payload_at, tls)
    crt = core.ClusterRuntime(cl, work_stealing=False, policy=table,
                              batched=True, batch_impl=_impl(pkg, impl),
                              batch_tile=0, tick_every=8)
    dsts = []
    for i, frames in enumerate(_frames(core, n_chans, n_msgs)):
        sw = i % n_workers
        dw = (sw + 1) % n_workers if i < cross else sw
        src = cl.socket(worker=sw, tls=tls)
        pair = [cl.socket(worker=dw, tls=tls) for _ in range(2)]
        crt.channel(src, pair, name=f"ch{i}")
        dsts += pair
        _load(src, frames, tls)
    _drive(crt, executor)
    agg = cl.counters_aggregate()
    out = dict(wires=_wires(dsts, tls), msgs=crt.messages_forwarded(),
               counters=dataclasses.asdict(agg), snap=agg.snapshot(),
               verdicts=crt.policy_summary()["aggregate"],
               stats=dict(cl.stats), xfer=[_xfer(w.pool) for w in cl.workers])
    _device_plane_ok(cl, impl, out["counters"])
    crt.shutdown()
    assert cl.pages_in_use == 0
    return out


def _single_run(impl, tls, *, n_chans=9, n_msgs=4):
    stack = tcore.LibraStack(secret=b"cl", device="cpu", **STACK_KW)
    table = _table(tcore, t_payload_at, tls)
    rt = tcore.ProxyRuntime(stack, policy=table, batched=True,
                            batch_impl=impl, batch_tile=0, tick_every=8)
    dsts = []
    for i, frames in enumerate(_frames(tcore, n_chans, n_msgs)):
        src = stack.socket(tls=tls)
        pair = [stack.socket(tls=tls) for _ in range(2)]
        rt.channel(src, pair, name=f"ch{i}")
        dsts += pair
        _load(src, frames, tls)
    rt.run()
    out = dict(wires=_wires(dsts, tls), snap=stack.counters.snapshot(),
               verdicts=table.summary())
    rt.shutdown()
    return out


@pytest.mark.parametrize("executor", ["run", "parallel", "threads"])
@pytest.mark.parametrize("impl", IMPLS)
def test_device_plane_cluster_matches_jax_and_single_stack(impl, executor):
    j = _cluster_run("jax", impl, executor, None)
    t = _cluster_run("torch", impl, executor, None)
    assert t == j
    assert t["msgs"] > 0 and t["stats"]["grants"] > 0
    assert t["stats"]["copies"] == 0
    assert all(h > 0 for h in t["verdicts"]["rule_hits"])
    single = _single_run(impl, None)
    assert t["wires"] == single["wires"] and t["snap"] == single["snap"]
    host = _cluster_run("torch", "host", executor, None)
    for k in ("wires", "counters", "verdicts", "stats"):
        assert t[k] == host[k], k


@pytest.mark.parametrize("impl", ["fused-round", "auto"])
def test_device_plane_cluster_hw_ktls_matches_jax(impl):
    j = _cluster_run("jax", impl, "threads", "hw")
    t = _cluster_run("torch", impl, "threads", "hw")
    assert t == j and t["stats"]["grants"] > 0
    single = _single_run(impl, "hw")
    assert t["wires"] == single["wires"] and t["snap"] == single["snap"]


def _fallback_run(pkg, impl, executor):
    """Every flow from worker 0 to a destination worker above its
    watermark: the one-copy fallback reads the owner's pool."""
    core, payload_at, kw = PKGS[pkg]
    cl = core.LibraCluster(2, secret=b"cl", **STACK_KW, **kw)
    cl.workers[1].high_watermark = 0.0
    crt = core.ClusterRuntime(cl, work_stealing=False, batched=True,
                              batch_impl=_impl(pkg, impl), batch_tile=0)
    dsts = []
    for frames in _frames(core, 4, 3, seed=7):
        src = cl.socket(worker=0)
        dst = cl.socket(worker=1)
        crt.channel(src, dst)
        dsts.append(dst)
        _load(src, frames, None)
    _drive(crt, executor)
    out = dict(wires=_wires(dsts, None),
               counters=dataclasses.asdict(cl.counters_aggregate()),
               stats=dict(cl.stats), xfer=[_xfer(w.pool) for w in cl.workers])
    if impl != "host":
        assert out["counters"]["device_fallbacks"] == 0
        assert cl.workers[0].pool.xfer["device_rounds"] > 0
    crt.shutdown()
    assert cl.pages_in_use == 0
    return out


@pytest.mark.parametrize("executor", ["run", "threads"])
@pytest.mark.parametrize("impl", IMPLS)
def test_device_plane_watermark_fallback_matches_jax(impl, executor):
    j = _fallback_run("jax", impl, executor)
    t = _fallback_run("torch", impl, executor)
    assert t == j
    assert t["stats"]["copies"] > 0 and t["stats"]["grants"] == 0
    assert t["counters"]["cross_worker_copied"] == t["stats"]["copied_tokens"]
    host = _fallback_run("torch", "host", executor)
    assert t["wires"] == host["wires"] and t["stats"] == host["stats"]


def _kill_run(pkg, impl, executor, kill):
    core, _, kw = PKGS[pkg]
    rng = np.random.default_rng(5)
    frames = [[core.build_message(rng.integers(100, 200, 4),
                                  rng.integers(1000, 2000, 40))
               for _ in range(6)] for _ in range(6)]
    cl = core.LibraCluster(3, secret=b"ft", **STACK_KW, **kw)
    plan = core.FaultPlan(seed=3)
    if kill:
        plan.kill_worker(2, at=4)
    crt = core.ClusterRuntime(cl, fault_plan=plan, batched=True,
                              batch_impl=_impl(pkg, impl))
    dsts = []
    for i, chan_frames in enumerate(frames):
        src = cl.socket(worker=i % 3)
        dst = cl.socket(worker=0)
        crt.channel(src, dst, name=f"ch{i}")
        dsts.append(dst)
        _load(src, chan_frames, None)
    if executor == "threads":
        crt.run_parallel(threads=True, epoch_rounds=1)
    else:
        crt.run()
    out = dict(wires=_wires(dsts, None), stats=dict(cl.stats),
               snap=cl.counters_aggregate().snapshot(),
               log=list(plan.log), summary=plan.summary())
    _device_plane_ok(cl, impl, dataclasses.asdict(cl.counters_aggregate()))
    crt.shutdown()       # asserts zero leaked pages/grants everywhere
    return out


@pytest.mark.parametrize("executor", ["run", "threads"])
@pytest.mark.parametrize("impl", IMPLS)
def test_device_plane_kill_migration_matches_jax(impl, executor):
    j = _kill_run("jax", impl, executor, True)
    t = _kill_run("torch", impl, executor, True)
    assert t == j
    assert t["stats"]["worker_kills"] == 1
    assert t["stats"]["migrated_flows"] >= 1
    ref = _kill_run("torch", impl, executor, False)
    assert t["wires"] == ref["wires"] and t["snap"] == ref["snap"]


def _dead_owner_run(pkg, impl):
    """Worker 0 takes the message in by a batched round (its rows are
    then device-truth), grants it to worker 1 and dies: the grant is
    copied out of the dying pool and still transmits."""
    core, _, kw = PKGS[pkg]
    cl = core.LibraCluster(2, secret=b"ft", **STACK_KW, **kw)
    w0, w1 = cl.workers
    crt = core.ClusterRuntime(cl)
    src = cl.socket(worker=0)
    dst = cl.socket(worker=1)
    payload = np.arange(1000, 1040)
    src.deliver(core.build_message(np.array([7, 1, 2, 3]), payload))
    (buf, _n), = w0.recv_batch([src], impl=_impl(pkg, impl)).values()
    dirty = len(w0.pool.dirty_rows())
    vpi = next(iter(src.connection.anchored))
    granted = cl.grant_into(w1, vpi)
    assert granted is not None and w0.alloc.granted_out_pages > 0
    info = crt.kill_worker(0)
    assert w0.alloc.free_pages == w0.alloc.total_pages
    assert w0.alloc.granted_out_pages == 0
    out = buf.copy()
    out[-1] = core.VpiRegistry.to_token(granted)
    dst.send(out)
    wire = np.array(dst.tx_wire())
    assert np.array_equal(wire[-len(payload):], payload)
    res = dict(wire=wire.tolist(), info=info, stats=dict(cl.stats),
               dirty=dirty, counters=dataclasses.asdict(w1.counters))
    crt.shutdown()
    return res


@pytest.mark.parametrize("impl", IMPLS)
def test_device_plane_dead_owner_copy_out_matches_jax(impl):
    j = _dead_owner_run("jax", impl)
    t = _dead_owner_run("torch", impl)
    assert t == j
    assert t["dirty"] > 0             # the copy-out read device-truth rows
    assert t["info"]["grants_copied_out"] == 1
    assert t["stats"]["dead_grants_copied"] == 1


@pytest.mark.parametrize("executor", ["run", "threads"])
def test_cuda_cluster_without_gpu_raises_at_first_device_round(executor):
    """``LibraCluster`` forwards its default ``device="cuda"`` to every
    worker: with no GPU the first device round raises, in a worker thread
    too (``run_parallel`` re-raises it); it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU rule cannot be exercised")
    cl = tcore.LibraCluster(2, secret=b"cl", **STACK_KW)
    assert all(w.pool.device == "cuda" for w in cl.workers)
    crt = tcore.ClusterRuntime(cl, work_stealing=False, batched=True,
                               batch_impl="fused-round")
    for w in (0, 1):
        src = cl.socket(worker=w)
        crt.channel(src, cl.socket(worker=1 - w))
        src.deliver(tcore.build_message(np.arange(4), np.arange(30)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if executor == "threads":
            crt.run_parallel(threads=True)
        else:
            crt.run()
    assert not any(w.pool.resident for w in cl.workers)


#: DevicePool methods that read or write its host state (dirty-row masks,
#: ``xfer``) on the device plane, none of them under the plane lock
POOL_HOST_STATE = ("_round_setup", "_upload_rows", "_materialize_rows",
                   "_note_round", "gather_batch_device", "read_payload")


@pytest.mark.parametrize("kill", [False, True], ids=["steady", "kill"])
@pytest.mark.parametrize("impl", ["fused-round", "auto"])
def test_threaded_workers_touch_only_their_own_pool(impl, kill,
                                                    monkeypatch):
    """Under ``run_parallel(threads=True)`` with cross-worker grants, a
    pool's host state is touched by its own worker's thread and, between
    epochs, by the main thread, never by a peer's thread: a channel runs
    on its source's worker, which owns the anchor, so a grant is gathered
    out of the owner's pool on the owner's thread. The port, like the
    JAX package, takes no lock around a peer-pool gather; this holds it
    to needing none."""
    seen = collections.defaultdict(set)
    for name in POOL_HOST_STATE:
        def traced(self, *a, _orig=getattr(DevicePool, name), **kw):
            seen[id(self)].add(threading.current_thread().name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(DevicePool, name, traced)
    cl = tcore.LibraCluster(3, secret=b"cl", device="cpu", **STACK_KW)
    plan = tcore.FaultPlan(seed=3)
    if kill:
        plan.kill_worker(2, at=3)
    crt = tcore.ClusterRuntime(cl, work_stealing=False, fault_plan=plan,
                               policy=_table(tcore, t_payload_at, None),
                               batched=True, batch_impl=impl, batch_tile=0,
                               tick_every=8)
    for i, frames in enumerate(_frames(tcore, 9, 6)):
        src = cl.socket(worker=i % 3)
        crt.channel(src, [cl.socket(worker=(i + 1) % 3) for _ in range(2)],
                    name=f"ch{i}")
        _load(src, frames, None)
    crt.run_parallel(threads=True, epoch_rounds=1)
    assert cl.stats["grants"] > 0
    assert cl.stats["worker_kills"] == int(kill)
    for i, w in enumerate(cl.workers):
        own = f"libra-worker-{i}"
        assert own in seen[id(w.pool)], (i, seen[id(w.pool)])
        assert seen[id(w.pool)] <= {own, "MainThread"}, \
            (i, seen[id(w.pool)])
    crt.shutdown()
