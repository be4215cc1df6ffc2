"""The port's engine benches against the JAX package's, on the CPU at the
smoke sizes, with the JAX parameters carried across
(``models.convert.params_from_jax``), so tokens compare too.

* ``copy_overhead``, ``throughput`` and ``single_stream``: ``main()``'s
  smoke rows (the stream-level sections), and the engine sections of
  ``copy_overhead`` and ``single_stream`` called directly: the same row
  names, equal rows once the wall clock's fields are dropped, and each
  engine's output tokens equal.
* ``microarch``: ``main()`` whole (it always serves).
* ``sota``: its rows hold only timings, so only the port's runs: the
  reference's row names, and every engine of a row generating the same
  number of tokens.
* ``common.proxy_model``: the reduced ``libra-proxy-125m`` under smoke,
  the full one otherwise.
"""
import pytest

import _bench_twin
from benchmarks_torch import common


def _twin(bench, tmp_path, monkeypatch, call_j=None, call_t=None,
          spy=False):
    import importlib

    seen = {}
    if spy:
        jmod = importlib.import_module(f"benchmarks.{bench}")
        tmod = importlib.import_module(f"benchmarks_torch.{bench}")
        _bench_twin.jax_params(monkeypatch, tmod)
        seen = {"jax": _bench_twin.engine_spy(monkeypatch, jmod),
                "torch": _bench_twin.engine_spy(monkeypatch, tmod)}
    ref = _bench_twin.jax_rows(bench, tmp_path, monkeypatch, call_j)
    port = _bench_twin.torch_rows(bench, tmp_path, monkeypatch, call_t)
    _bench_twin.assert_same_rows(port, ref)
    if spy:
        assert seen["torch"] == seen["jax"] and seen["jax"]
    return port


@pytest.mark.parametrize("bench", ["bench_copy_overhead", "bench_throughput",
                                   "bench_single_stream"])
def test_smoke_rows_match_the_reference(bench, tmp_path, monkeypatch):
    _twin(bench, tmp_path, monkeypatch)


@pytest.mark.parametrize("bench", ["bench_copy_overhead",
                                   "bench_single_stream"])
def test_engine_section_matches_the_reference(bench, tmp_path, monkeypatch):
    rows = _twin(bench, tmp_path, monkeypatch,
                 call_j=lambda m: m.engine_section(),
                 call_t=lambda m: m.engine_section("cpu"), spy=True)
    assert rows


def test_microarch_matches_the_reference(tmp_path, monkeypatch):
    rows = _twin("bench_microarch", tmp_path, monkeypatch, spy=True)
    assert len(rows) == 12


def test_sota_rows_and_tokens(tmp_path, monkeypatch):
    from benchmarks_torch import bench_sota

    monkeypatch.setenv("LIBRA_BENCH_SMOKE", "1")
    out = bench_sota.run("cpu")
    assert list(out) == [f"fig8_conc{c}_ctx{x}" for c in (2, 8)
                         for x in (32, 128, 320)]
    for row, engines in out.items():
        assert list(engines) == ["standard", "copier", "libra"]
        conc = int(row.split("_")[1][4:])
        assert {toks for toks, _dt in engines.values()} == {conc * 8}, row


def test_proxy_model_is_reduced_under_smoke_and_full_otherwise(monkeypatch):
    import repro_torch.models.registry as registry

    built = []

    class Stub:
        def init_params(self, seed, *, device):
            return (seed, device)

    def build_model(cfg, page_size):
        built.append((cfg.name, cfg.num_layers, cfg.d_model, cfg.num_heads,
                      cfg.d_model // cfg.num_heads, cfg.vocab_size,
                      page_size))
        return Stub()

    monkeypatch.setattr(registry, "build_model", build_model)
    monkeypatch.setenv("LIBRA_BENCH_SMOKE", "1")
    _c, _m, params = common.proxy_model(device="cpu")
    assert params == (0, "cpu")
    monkeypatch.delenv("LIBRA_BENCH_SMOKE")
    common.proxy_model(page_size=16, device="cpu")
    assert built == [("libra-proxy-reduced", 2, 64, 4, 16, 256, 8),
                     ("libra-proxy-125m", 12, 768, 12, 64, 32000, 16)]
