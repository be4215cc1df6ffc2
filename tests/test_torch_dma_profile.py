"""The fused round's ring depth on the main path, and the port's
``kernels/dma_profile.py``.

* ``LibraStack`` passes ``pool.fused_buffers`` to ``ops.fused_round`` as
  ``n_buffers`` on every fused round (a spy on both packages' ``ops``),
  and a run at depth 0, 2 or 4 ends identical to the JAX package's stack
  with the same ``fused_buffers``, under ``'fused-round:ref'`` and the
  port's ``'fused-round'``.
* ``fused_buffers = 1`` raises from ``recv_batch``.
* The ``fused_round`` wrapper records each launch's ring depth in
  ``FUSED_DEPTHS`` (a fake kernel stands in for the card).
* ``auto_buffer_depth`` honours ``LIBRA_FUSED_BUFFERS`` and otherwise
  picks the fastest of the profiles it is given; ``profile_fused_depths``
  and ``dma_compute_profile`` run on the CPU. Nothing here depends on how
  long anything takes.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.kernels.ops as jops
import repro_torch.core as tcore
import repro_torch.kernels.ops as tops
from repro.core.crypto import REC_HEADER
from repro.core.policy import payload_at as j_payload_at
from repro_torch.core.policy import payload_at as t_payload_at
from repro_torch.kernels import _build
from repro_torch.kernels import dma_profile as dp
from repro_torch.kernels import selective_copy as kern
from repro_torch.kernels import testing as tt

PKGS = {"jax": (jcore, jops, j_payload_at, {}),
        "torch": (tcore, tops, t_payload_at, {"device": "cpu"})}
STACK_KW = dict(n_shards=4, pages_per_shard=128, page_size=16)
TAG = 3


@pytest.fixture(autouse=True)
def _jax_gathers_every_round_on_device(monkeypatch):
    """The port gathers every device-plane round on the device; the JAX
    package's small-gather host shortcut is set to 0 so ``xfer``
    compares."""
    monkeypatch.setattr(f"{jcore.__name__}.stack._SMALL_GATHER_ROWS", 0)


def _run(pkg, impl, depth, tls, monkeypatch):
    """A policy-routed batched run at ``fused_buffers = depth``: what it
    forwarded and counted, and the ``n_buffers`` of each fused round."""
    core, ops, payload_at, kw = PKGS[pkg]
    seen = []
    fused = ops.fused_round

    def spy(*args, **kwargs):
        seen.append(kwargs["n_buffers"])
        return fused(*args, **kwargs)

    monkeypatch.setattr(ops, "fused_round", spy)
    stack = core.LibraStack(secret=b"dp", **STACK_KW, **kw)
    stack.pool.fused_buffers = depth
    off = (REC_HEADER if tls else 0) + TAG
    table = core.PolicyTable([
        core.rule(core.drop(), core.between(off, 196, 199)),
        core.rule(core.forward(1), payload_at(0, 1950, 2000)),
        core.rule(core.forward(0), core.between(off, 100, 199)),
    ])
    rt = core.ProxyRuntime(stack, tick_every=32, batched=True,
                           batch_impl=impl, policy=table)
    rng = np.random.default_rng(4)
    for i in range(5):
        src = stack.socket("length-prefixed", tls=tls)
        dsts = [stack.socket("length-prefixed", tls=tls) for _ in range(2)]
        rt.channel(src, dsts, name=f"ch{i}")
        frames = [core.build_message(
            np.concatenate([[rng.choice([120, 150, 197])],
                            rng.integers(100, 200, 3)]),
            rng.integers(1000, 2000, int(rng.integers(9, 40))))
            for _ in range(4)]
        src.deliver(src.tls.seal_frames(frames, src.parser.inner) if tls
                    else np.concatenate(frames))
    rt.run()
    monkeypatch.setattr(ops, "fused_round", fused)
    wires = [(d.tls.open_wire(d.tx_wire()) if tls else d.tx_wire()).tolist()
             for ch in rt.channels for d in ch.dsts]
    xfer = dict(stack.pool.xfer)
    xfer.pop("donated_rounds")
    xfer.pop("host_gathers", None)
    out = dict(wires=wires, counters=dataclasses.asdict(stack.counters),
               verdicts=table.summary(), xfer=xfer,
               msgs=rt.messages_forwarded(),
               fused_buffers=stack.pool.fused_buffers)
    rt.shutdown()
    assert stack.alloc.free_pages == stack.alloc.total_pages
    return out, seen


@pytest.mark.parametrize("tls", [None, "hw"])
@pytest.mark.parametrize("impl", ["fused-round:ref", "fused-round"])
@pytest.mark.parametrize("depth", [0, 2, 4])
def test_stack_passes_fused_buffers_and_matches_jax(depth, impl, tls,
                                                    monkeypatch):
    j, j_seen = _run("jax", "fused-round:ref", depth, tls, monkeypatch)
    t, t_seen = _run("torch", impl, depth, tls, monkeypatch)
    assert t_seen and t_seen == [depth] * len(t_seen)
    assert j_seen == t_seen
    assert t == j
    assert t["xfer"]["fused_rounds"] == len(t_seen) > 0
    # the depth changes nothing the run computes
    base, _ = _run("torch", impl, 0, tls, monkeypatch)
    base["fused_buffers"] = depth
    assert t == base


def test_fused_buffers_of_one_raises_from_recv_batch():
    stack = tcore.LibraStack(secret=b"dp", device="cpu", **STACK_KW)
    stack.pool.fused_buffers = 1
    src = stack.socket("length-prefixed")
    src.deliver(tcore.build_message(np.arange(4), np.arange(1000, 1040)))
    with pytest.raises(ValueError, match="n_buffers=1"):
        stack.recv_batch([src], impl="fused-round")


def test_wrapper_records_the_ring_depth_of_each_launch(monkeypatch):
    """``fused_round`` counts each launch under its ring depth (0 runs the
    default); a fake launch stands in for the kernel on the CPU."""
    launched = []
    monkeypatch.setattr(kern, "_check", lambda *a, **k: None)
    monkeypatch.setattr(kern, "_smem_limit", lambda dev: None)
    monkeypatch.setattr(_build, "launch",
                        lambda name, dev, *args: launched.append(args[-1]))
    monkeypatch.setattr(kern, "LAUNCHES", dict.fromkeys(kern.LAUNCHES, 0))
    monkeypatch.setattr(kern, "FUSED_DEPTHS", {})
    case = tt.to_torch(tt.fused_round_case(np.random.default_rng(0)))
    for depth in (0, 0, 3, 4, 8):
        kern.fused_round(case["stream"], case["meta_len"],
                         case["total_len"], case["pool"], case["tables"],
                         meta_max=16, n_buffers=depth)
    d = kern.DEFAULT_FUSED_DEPTH
    assert launched == [d, d, 3, 4, 8]
    assert kern.FUSED_DEPTHS == {d: 2, 3: 1, 4: 1, 8: 1}
    assert kern.LAUNCHES["fused_round"] == 5
    with pytest.raises(ValueError):
        kern.fused_round(case["stream"], case["meta_len"],
                         case["total_len"], case["pool"], case["tables"],
                         meta_max=16, n_buffers=1)
    assert kern.LAUNCHES["fused_round"] == 5
    kern.reset_launches()
    assert kern.FUSED_DEPTHS == {} and kern.LAUNCHES["fused_round"] == 0


@pytest.mark.parametrize("env,want", [("0", 0), ("2", 2), ("4", 4)])
def test_auto_buffer_depth_honours_the_override(env, want, monkeypatch):
    monkeypatch.setenv("LIBRA_FUSED_BUFFERS", env)
    # the override wins before anything is measured (no profiles, no card)
    assert dp.auto_buffer_depth() == want


@pytest.mark.parametrize("env", ["1", "-2"])
def test_auto_buffer_depth_refuses_a_depth_of_one(env, monkeypatch):
    monkeypatch.setenv("LIBRA_FUSED_BUFFERS", env)
    with pytest.raises(ValueError, match="LIBRA_FUSED_BUFFERS"):
        dp.auto_buffer_depth()


def test_auto_buffer_depth_picks_the_fastest_profile(monkeypatch):
    monkeypatch.delenv("LIBRA_FUSED_BUFFERS", raising=False)
    profiles = {d: dp.DepthProfile(depth=d, ring_depth=kern.ring_depth(d),
                                   round_s=s, rounds_per_s=1 / s)
                for d, s in ((0, 3e-5), (2, 2e-5), (4, 1e-5), (8, 4e-5))}
    assert dp.auto_buffer_depth(profiles=profiles) == 4
    profiles[0].round_s = 5e-6
    assert dp.auto_buffer_depth(profiles=profiles) == 0


def test_auto_buffer_depth_picks_by_kernel_time_where_every_depth_has_one(
        monkeypatch):
    """With a CUDA-event kernel time on every profile, the least kernel
    time wins whatever the wall times say; one missing sends the pick back
    to the wall time."""
    monkeypatch.delenv("LIBRA_FUSED_BUFFERS", raising=False)
    profiles = {d: dp.DepthProfile(depth=d, ring_depth=kern.ring_depth(d),
                                   round_s=r, rounds_per_s=1 / r, kernel_s=k)
                for d, r, k in ((0, 9e-5, 9.4e-6), (2, 8e-5, 9.3e-6),
                                (4, 7e-5, 9.6e-6), (8, 6e-5, 1.3e-5))}
    assert dp.auto_buffer_depth(profiles=profiles) == 2
    profiles[8].kernel_s = None
    assert dp.auto_buffer_depth(profiles=profiles) == 8


def test_profile_fused_depths_on_the_cpu(monkeypatch):
    monkeypatch.delenv("LIBRA_FUSED_BUFFERS", raising=False)
    depths = (0, 2, 3, 4, 8)
    for keystreams in (True, False):
        profs = dp.profile_fused_depths(depths=depths, iters=1, warmup=0,
                                        impl="ref", device="cpu",
                                        keystreams=keystreams)
        assert list(profs) == list(depths)
        for d, p in profs.items():
            assert p.depth == d and p.ring_depth == kern.ring_depth(d)
            assert p.round_s > 0 and p.kernel_s is None
        assert profs[0].ring_depth == profs[2].ring_depth
        assert dp.auto_buffer_depth(profiles=profs) in depths
    for impl in ("ref", "auto"):
        assert dp.auto_buffer_depth(depths=(0, 2), iters=1, warmup=0,
                                    impl=impl, device="cpu") in (0, 2)


def test_profiler_refuses_a_depth_of_one():
    with pytest.raises(ValueError, match="n_buffers=1"):
        dp.profile_fused_depths(depths=(0, 1), iters=1, warmup=0,
                                impl="ref", device="cpu")


def test_profiler_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp.profile_fused_depths(iters=1, warmup=0)


def test_dma_compute_profile_on_the_cpu():
    for n_buffers in (0, 2, 4):
        out = dp.dma_compute_profile(iters=1, warmup=0, impl="ref",
                                     device="cpu", n_buffers=n_buffers)
        assert set(out) == {"transfer_s", "compute_s", "fused_s",
                            "overlap_ratio"}
        assert all(np.isfinite(v) and v >= 0 for v in out.values())
        assert 0.0 <= out["overlap_ratio"] <= 1.0
    with pytest.raises(ValueError):
        dp.dma_compute_profile(iters=1, warmup=0, impl="ref", device="cpu",
                               n_buffers=1)


def test_dma_profile_imports_no_jax():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(dp))
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names
                if m.split(".")[0] in ("jax", "jaxlib", "repro")]


def test_bench_dma_overlap_smoke_on_the_cpu(tmp_path, monkeypatch):
    """The port's ``bench_dma_overlap`` at the reference's smoke shape on
    the CPU: one row a depth with its ring depth, the split, the pick; and
    its artifacts go to ``results/bench_torch/``, never ``results/bench/``."""
    import json

    from benchmarks_torch import bench_dma_overlap, common

    monkeypatch.setenv("LIBRA_BENCH_SMOKE", "1")
    monkeypatch.delenv("LIBRA_FUSED_BUFFERS", raising=False)
    bench_dma_overlap.main(["--device", "cpu", "--out", str(tmp_path)])
    art = json.loads((tmp_path / "BENCH_dma_overlap.json").read_text())
    assert art["bench"] == "dma_overlap" and art["smoke"] is True
    rows = {r["name"]: r for r in art["rows"]}
    for d in dp.DEFAULT_DEPTHS:
        row = rows[f"dma_overlap_depth{d}_series"]
        assert row["ring_depth"] == kern.ring_depth(d)
        assert row["kernel_us"] is None and row["device"] == "cpu"
    assert 0 <= rows["dma_overlap_decomposition_series"][
        "overlap_ratio"] <= 1
    assert rows["dma_overlap_selected_series"]["auto_depth"] in \
        dp.DEFAULT_DEPTHS
    assert common.OUT_DIR.endswith("results/bench_torch")
