"""Twin runner of the benches: a bench of the JAX package (``benchmarks/``)
and its port (``benchmarks_torch/``) run on the CPU at the smoke sizes,
each one's rows collected through its own ``common.flush_artifact`` into
a temporary directory, and compared once the port's
``common.untimed`` has dropped what the wall clock decides.

While the JAX side runs, its ``stack._SMALL_GATHER_ROWS`` is 0 (as in
``_twin.py``): the port gathers every device-plane round on the device.
:func:`engine_spy` replaces a bench module's ``run_engine`` by one that
records each engine's output tokens, and :func:`jax_params` makes the
port's bench serve the JAX package's parameters (carried across with
``models.convert.params_from_jax``), so the tokens compare too.
"""
from __future__ import annotations

import importlib
import json

import benchmarks.common as jcommon
import repro.core.stack as jstack
from benchmarks_torch import common as tcommon


def _rows(common, bench: str, out) -> list:
    path = common.flush_artifact(bench, str(out))
    with open(path) as f:
        return json.load(f)["rows"]


def jax_rows(bench: str, tmp_path, monkeypatch, call=None) -> list:
    """The rows of ``benchmarks.<bench>``'s ``main()`` (or of ``call``,
    given the module) under ``LIBRA_BENCH_SMOKE=1``."""
    monkeypatch.setenv("LIBRA_BENCH_SMOKE", "1")
    monkeypatch.setattr(jstack, "_SMALL_GATHER_ROWS", 0)
    monkeypatch.setattr(jcommon, "_ARTIFACT_ROWS", [])
    mod = importlib.import_module(f"benchmarks.{bench}")
    (call or (lambda m: m.main()))(mod)
    return _rows(jcommon, bench, tmp_path / "jax")


def torch_rows(bench: str, tmp_path, monkeypatch, call=None) -> list:
    """The rows of ``benchmarks_torch.<bench>``'s ``main`` on the CPU (or
    of ``call``, given the module) under ``LIBRA_BENCH_SMOKE=1``."""
    monkeypatch.setenv("LIBRA_BENCH_SMOKE", "1")
    monkeypatch.setattr(tcommon, "_ARTIFACT_ROWS", [])
    mod = importlib.import_module(f"benchmarks_torch.{bench}")
    (call or (lambda m: m.main(["--device", "cpu"])))(mod)
    return _rows(tcommon, bench, tmp_path / "torch")


def assert_same_rows(port: list, ref: list) -> None:
    """The same row names in the same order, and equal rows once
    ``untimed`` has dropped the wall clock's fields."""
    assert [r["name"] for r in port] == [r["name"] for r in ref]
    for t, j in zip(port, ref):
        assert tcommon.untimed(t) == tcommon.untimed(j), t["name"]


def engine_spy(monkeypatch, mod) -> list:
    """Replace ``mod.run_engine`` by a spy; returns the list it fills with
    each run's ``{request id: output tokens}``."""
    seen = []
    run_engine = mod.run_engine

    def spy(*args, **kw):
        eng, dt = run_engine(*args, **kw)
        seen.append({r.rid: [int(t) for t in r.output]
                     for r in eng.completed})
        return eng, dt

    monkeypatch.setattr(mod, "run_engine", spy)
    return seen


def jax_params(monkeypatch, mod) -> None:
    """Make ``mod.proxy_model`` return the port's reduced model with the
    JAX package's ``proxy_model`` parameters."""
    from benchmarks.common import proxy_model as jax_proxy_model
    from repro_torch.configs import get_reduced
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.registry import build_model

    def proxy_model(page_size: int = 8, device="cuda"):
        _cfg, _model, params = jax_proxy_model(page_size=page_size)
        cfg = get_reduced("libra-proxy-125m")
        model = build_model(cfg, page_size=page_size)
        return cfg, model, params_from_jax(params, model, device=device)

    monkeypatch.setattr(mod, "proxy_model", proxy_model)
