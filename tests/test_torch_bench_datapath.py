"""The port's datapath benches (``benchmarks_torch/``) against the JAX
package's (``benchmarks/``), on the CPU at the smoke sizes.

* ``proxy_runtime``, ``batched_datapath``, ``policy_proxy`` and
  ``ktls_proxy``: the same row names, and equal rows once the wall
  clock's fields are dropped (``common.untimed``): counters, ``xfer``,
  launches, identity flags and message counts. The port runs the
  reference's ``'ref'`` and ``'fused-round:ref'`` as ``'auto'`` and
  ``'fused-round'``, their plain versions on the CPU.
* Every ``assert`` of a reference bench (gates and identity checks) is in
  its port, as the same expression.
* No file under ``benchmarks_torch/``, no module of ``src/repro_torch/``,
  ``chip_smoke.py``, and none of the port's examples and scripts
  (``examples/*_torch.py``, ``scripts/*_torch.py``) imports ``repro``,
  ``jax`` or ``benchmarks``.
* ``common.untimed``, ``common.DEPLOYMENT`` and ``run.py``: what a bench
  that raises leaves, and that a bench asked for ``cuda`` without a card
  raises.
"""
import ast
import json
from pathlib import Path

import pytest

import _bench_twin
from benchmarks_torch import common, run

ROOT = Path(__file__).resolve().parents[1]

DATAPATH = ("bench_proxy_runtime", "bench_batched_datapath",
            "bench_policy_proxy", "bench_ktls_proxy")


@pytest.mark.parametrize("bench", DATAPATH)
def test_rows_match_the_reference(bench, tmp_path, monkeypatch):
    ref = _bench_twin.jax_rows(bench, tmp_path, monkeypatch)
    port = _bench_twin.torch_rows(bench, tmp_path, monkeypatch)
    _bench_twin.assert_same_rows(port, ref)


def _asserts(path: Path) -> set:
    return {ast.unparse(n.test) for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Assert)}


REF_BENCHES = sorted(p.name for p in (ROOT / "benchmarks").glob("bench_*.py"))


@pytest.mark.parametrize("name", REF_BENCHES)
def test_every_reference_assert_is_carried(name):
    """Each bench of ``benchmarks/`` has its port, holding every gate and
    identity check of the reference as the same expression."""
    port = ROOT / "benchmarks_torch" / name
    assert port.exists(), f"{name} has no port"
    missing = _asserts(ROOT / "benchmarks" / name) - _asserts(port)
    assert not missing, missing


def test_the_runner_lists_the_references_benches():
    ref = ROOT / "benchmarks" / "run.py"
    lists = {}
    for node in ast.parse(ref.read_text()).body:
        if isinstance(node, ast.Assign) and node.targets[0].id in (
                "BENCHES", "SMOKE_BENCHES"):
            lists[node.targets[0].id] = [
                (e.elts[0].value, e.elts[1].value.split(".")[1])
                for e in node.value.elts]
    for name, port in (("BENCHES", run.BENCHES),
                       ("SMOKE_BENCHES", run.SMOKE_BENCHES)):
        assert [(n, m.split(".")[1]) for n, m in port] == lists[name]
        assert all(m.startswith("benchmarks_torch.") for _n, m in port)


PORT_FILES = sorted(
    [*(ROOT / "benchmarks_torch").glob("*.py"),
     *(ROOT / "src" / "repro_torch").rglob("*.py"),
     *(ROOT / "examples").glob("*_torch.py"),
     *(ROOT / "scripts").glob("*_torch.py"),
     ROOT / "chip_smoke.py"])


def _imported(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_the_port_imports_no_reference(path):
    assert not _imported(path) & {"repro", "jax", "jaxlib", "benchmarks"}


def test_untimed_drops_the_clock_and_keeps_the_counts():
    row = {"name": "x", "us_per_call": 3.0, "msgs_per_s": 9.0,
           "rounds_per_s": 1.0, "real_wall_s": 0.1, "proxy_dt": 0.2,
           "speedup_vs_1w": 2.0, "fused_over_multi": 1.1, "ratio": 0.9,
           "impl": "auto", "xfer_donated_rounds": 4, "xfer_host_gathers": 0,
           "xfer_device_rounds": 4, "anchored": 7, "counters_match": True,
           "derived": "msgs_per_s=12 rounds=9 round_us=3.1 impl=ref "
                      "counters_match=True launches_12_to_7 tok/s=4.0 "
                      "slowdown_vs_plain=2.84 "
                      "rx_copied=15tok of 2063 (0.0073)"}
    assert common.untimed(row) == {
        "name": "x", "xfer_device_rounds": 4, "anchored": 7,
        "counters_match": True,
        "derived": "rounds=9 counters_match=True launches_12_to_7 "
                   "rx_copied=15tok of 2063 (0.0073)"}


def test_the_deployment_is_chip_smokes_pool_with_a_short_header():
    from repro_torch.core.crypto import REC_HEADER

    d = common.DEPLOYMENT
    assert d.pages * d.page * 4 == 128 << 20
    assert (d.page * 4, d.meta * 4, d.payload * 4) == (4096, 512, 32768)
    # the kTLS header and the framing stay inside the parser's lookahead
    assert 3 + REC_HEADER + d.meta < 256


def test_a_bench_that_raises_writes_an_error_row(tmp_path, monkeypatch,
                                                 capsys):
    import sys
    import types

    mod = types.ModuleType("failing_bench")

    def main(argv):
        common.record("partial", n=1)
        raise ValueError("boom")

    mod.main = main
    monkeypatch.setitem(sys.modules, "failing_bench", mod)
    fails = run.run([("failing", "failing_bench")], device="cpu",
                    out_dir=str(tmp_path))
    assert fails == 1
    art = json.loads((tmp_path / "BENCH_failing.json").read_text())
    assert [r["name"] for r in art["rows"]] == ["partial", "ERROR"]
    assert art["rows"][1]["error"] == "ValueError: boom"
    monkeypatch.setattr(run, "BENCHES", [("failing", "failing_bench")])
    with pytest.raises(SystemExit, match="1 benchmark module"):
        run.main(["--device", "cpu", "--out", str(tmp_path)])


def test_a_bench_asked_for_cuda_without_a_card_raises(monkeypatch):
    import torch

    from benchmarks_torch import bench_proxy_runtime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_proxy_runtime.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.run(run.SMOKE_BENCHES, device="cuda", out_dir="unused")


def test_the_smoke_run_writes_only_under_its_out_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("LIBRA_BENCH_SMOKE", "1")
    fails = run.run(run.SMOKE_BENCHES, device="cpu", out_dir=str(tmp_path),
                    only="fig6_stream_proxy")
    assert fails == 0
    art = json.loads((tmp_path / "BENCH_fig6_stream_proxy.json").read_text())
    assert art["smoke"] is True and art["rows"]
    assert common.OUT_DIR.endswith("results/bench_torch")
