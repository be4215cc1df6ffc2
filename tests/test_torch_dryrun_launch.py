"""The port's launch layer: the dry-run on small fake meshes.

Twins of ``tests/test_dryrun_launch.py``. The port's dry-run runs a cell
on rank 0 of a fake process group under ``FakeTensorMode``
(``repro_torch.launch.dryrun``), in this process; the JAX package's side
of the cell comparison runs in a subprocess of its own (its device count
is fixed when jax starts), with a timeout of its own."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.common.sharding import STRATEGIES, make_mesh, use_rules
from repro_torch.common.types import ShapeSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [("phi4-mini-3.8b", ("t", 64, 8, "train")),
         ("qwen2-moe-a2.7b", ("t", 64, 8, "train")),
         ("phi3-mini-3.8b", ("d", 64, 8, "decode")),
         ("hymba-1.5b", ("d", 64, 8, "decode"))]
#: each spawned process's own limit, seconds
PROC_TIMEOUT = 180


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True,
                          timeout=PROC_TIMEOUT, env=env)


def test_mesh_function_does_not_touch_devices_on_import():
    r = _run("""
        import torch
        import torch.distributed as dist
        import repro_torch.launch.mesh as m
        # importing the module starts no process group and no CUDA
        assert callable(m.make_production_mesh)
        assert not dist.is_initialized()
        assert not torch.cuda.is_initialized()
        print("OK")
    """)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "OK"


def _jax_costs(strategies):
    """The JAX package's analyzer on the same four cells, each under the
    rules of its strategy (``strategies``: ``{arch: name}``), as
    ``run_cell`` scopes them: ``{arch: (flops, ring collective bytes)}``."""
    r = _run("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax
        from repro.common.sharding import (AxisType, STRATEGIES, make_mesh,
                                           use_rules)
        from repro.common.types import ShapeSpec
        from repro.configs import get_reduced
        from repro.launch import dryrun
        from repro.roofline.hlo_analysis import analyze_hlo_text

        mesh = make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
        strategies = %r
        for arch, s in %r:
            cfg, shape = get_reduced(arch), ShapeSpec(*s)
            with mesh, use_rules(STRATEGIES[strategies[arch]]()):
                fn, args, shards, donate = dryrun.build_cell(cfg, shape, mesh)
                compiled = jax.jit(fn, in_shardings=shards,
                                   donate_argnums=donate).lower(*args).compile()
            c = analyze_hlo_text(compiled.as_text())
            print("COSTS", arch, c.flops, c.collective_ring)
    """ % (strategies, CELLS))
    assert r.returncode == 0, r.stderr[-3000:]
    return {ln.split()[1]: (int(ln.split()[2]), int(ln.split()[3]))
            for ln in r.stdout.splitlines() if ln.startswith("COSTS")}


#: how far a cell's ring collective bytes a device may lie from the JAX
#: analyzer's, as a factor either way. The two programs differ: XLA's CPU
#: backend computes the bfloat16 step in float32 (its collectives carry
#: twice the bytes), and GSPMD plans the whole program's collectives where
#: DTensor redistributes operation by operation (PERF.md lists each
#: cell's ratio). The mesh has 8 devices: a counter that took global for
#: local sizes, or lost a step's gathers or reductions, falls outside.
COLLECTIVE_FACTOR = 8


def test_small_mesh_train_and_decode_cells():
    """Run a train cell and a decode cell of each kind on a 2x4 fake mesh
    with the same build path the 512-device dry-run uses: every cell
    counts FLOPs; the dense train cell's per-device products are within
    10 % of the JAX analyzer's on the same cell (the other three ratios
    are in PERF.md); the counter counts each collective torch issues
    (``CommDebugMode``'s count of the functional collectives), and every
    cell's ring collective bytes lie within ``COLLECTIVE_FACTOR`` of the
    JAX analyzer's."""
    from torch.distributed.tensor.debug import CommDebugMode

    import repro_torch.configs as tconfigs
    from repro_torch.launch import dryrun

    ours, strategies = {}, {}
    with dryrun.fake_process_group(8):
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        for arch, s in CELLS:
            cfg, shape = tconfigs.get_reduced(arch), ShapeSpec(*s)
            strategies[arch] = dryrun.cell_strategy(cfg, shape, 8)
            with use_rules(STRATEGIES[strategies[arch]]()):
                fn, args, shards, donate = dryrun.build_cell(cfg, shape, mesh)
                with CommDebugMode() as comm:
                    res = dryrun.run_step(fn, args, shards, donate, mesh)
            costs = res["costs"]
            assert costs.flops > 0, arch
            assert res["memory"]["argument_bytes"] > 0, arch
            # the inputs' placement (distribute_tensor) is set-up: its
            # c10d broadcasts and scatters are not the step's
            issued = sum(n for op, n in comm.get_comm_counts().items()
                         if str(op).startswith("c10d_functional."))
            assert costs.collective_count == issued > 0, arch
            ours[arch] = (costs.flops, costs.collective_ring)
    theirs = _jax_costs(strategies)
    ratio = ours["phi4-mini-3.8b"][0] / theirs["phi4-mini-3.8b"][0]
    assert abs(ratio - 1) < 0.10, (ours, theirs)
    for arch in ours:
        print(arch, ours[arch], theirs[arch],
              [a / b for a, b in zip(ours[arch], theirs[arch])])
        coll = ours[arch][1] / theirs[arch][1]
        assert 1 / COLLECTIVE_FACTOR <= coll <= COLLECTIVE_FACTOR, \
            (arch, ours[arch], theirs[arch])


def test_dryrun_cli_writes_a_record(tmp_path):
    """``python -m repro_torch.launch.dryrun`` at production size (256
    fake ranks): an ``ok`` record with the memory, the counter's fields
    and the roofline under the reference's keys."""
    r = _run(f"""
        from repro_torch.launch.dryrun import main
        main(["--arch", "phi4-mini-3.8b", "--shape", "decode_32k",
              "--multipod", "single", "--out", {str(tmp_path)!r}])
    """)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(tmp_path / "phi4-mini-3.8b__decode_32k__singlepod.json") as f:
        rec = json.load(f)
    assert rec["ok"] and rec["n_chips"] == 256
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes",
                                  "peak_estimate_bytes"}
    assert set(rec["hlo"]) >= {"flops_per_device", "hbm_bytes_per_device",
                               "collective_bytes_naive",
                               "collective_bytes_ring",
                               "collective_breakdown", "collective_count"}
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "dominant", "model_flops_total",
                                    "hlo_flops_device", "useful_ratio"}
    assert rec["hlo"]["flops_per_device"] > 0
    assert rec["hlo"]["collective_count"] > 0
    assert 0 < rec["roofline"]["useful_ratio"] <= 1.5


def test_report_renders_records():
    """``roofline/report.py``'s rows: a cell's terms, a skip, a failure."""
    from repro_torch.roofline.report import fmt_row

    ok = {"arch": "a", "shape": "s", "mesh": "singlepod", "ok": True,
          "roofline": {"compute_s": 0.5, "memory_s": 1.25,
                       "collective_s": 0.0625, "dominant": "memory",
                       "useful_ratio": 0.75},
          "memory": {"peak_estimate_bytes": 3 * 2 ** 30}}
    assert fmt_row(ok) == ("| a | s | singlepod | 0.5000 | 1.2500 | 0.0625 | "
                           "**memory** | 0.75 | 3.0 GiB |")
    assert fmt_row({**ok, "skipped": True}).endswith("skip (full attention) |")
    assert fmt_row({**ok, "ok": False}).endswith("| FAIL |")


def test_dryrun_artifacts_complete():
    """Every (arch x shape x mesh) cell must be present and OK/skip in the
    committed dry-run results."""
    d = os.path.join(REPO, "results", "dryrun_torch")
    if not os.path.isdir(d):
        pytest.skip("dry-run sweep not yet produced")
    from repro_torch.configs import ARCHS

    shapes = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    missing, failed = [], []
    for arch in ARCHS:
        for shape in shapes:
            for pod in ("singlepod", "multipod"):
                p = os.path.join(d, f"{arch}__{shape}__{pod}.json")
                if not os.path.exists(p):
                    missing.append((arch, shape, pod))
                    continue
                with open(p) as f:
                    r = json.load(f)
                if not r.get("ok"):
                    failed.append((arch, shape, pod, r.get("error", "")[:80]))
    assert not missing, f"missing cells: {missing}"
    assert not failed, f"failed cells: {failed}"
