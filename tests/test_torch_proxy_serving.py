"""``examples/proxy_serving_torch.py`` against the JAX package's
``examples/proxy_serving.py``, on the CPU.

* ``stream_proxy("cpu")`` prints exactly what the reference's
  ``stream_proxy()`` prints.
* ``serving_proxy("cpu", params=...)``, with the parameters the reference
  makes (``init_params(PRNGKey(0))``, carried across with
  ``params_from_jax``), prints exactly the reference's lines, and leaves
  the pool as the reference's: each forwarded handle's pages stay held
  (``forward_handle`` retains the pages and the VPI, ``release_handle``
  frees the pages only when the VPI's count reaches zero), 57 of 60
  pages in both. A fault of the reference, carried (ROADMAP section 3,
  F6).
* The script exits 0 with ``--device cpu``, and raises with no card and
  no ``--device``.

Both packages' ``VpiRegistry`` draws its secret from ``os.urandom(16)``
once a stack, so the VPIs the serving part prints differ from run to run
of either package. The twins fix ``os.urandom`` for both runs, and every
line compares.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_reduced as j_reduced
from repro.models.registry import build_model as j_build
from repro.serving.engine import LibraEngine as JEngine
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model as t_build

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "proxy_serving_torch.py"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def examples():
    return _load("proxy_serving"), _load("proxy_serving_torch")


@pytest.fixture
def fixed_secret(monkeypatch):
    monkeypatch.setattr(os, "urandom", lambda n: bytes(range(n)))


def _printed(capsys, fn, *args, **kw) -> list:
    capsys.readouterr()
    fn(*args, **kw)
    return capsys.readouterr().out.splitlines()


def test_stream_proxy_prints_the_references_lines(examples, capsys,
                                                  fixed_secret):
    ref, port = examples
    want = _printed(capsys, ref.stream_proxy)
    got = _printed(capsys, port.stream_proxy, "cpu")
    assert got == want
    assert got[0].startswith("--- stream proxy") and len(got) == 7


def test_serving_proxy_prints_the_references_lines(examples, capsys,
                                                   fixed_secret,
                                                   monkeypatch):
    ref, port = examples
    jax_engines = []
    init = JEngine.__init__

    def keep(self, *args, **kw):
        init(self, *args, **kw)
        jax_engines.append(self)

    monkeypatch.setattr(JEngine, "__init__", keep)
    jmodel = j_build(j_reduced("libra-proxy-125m"), page_size=8)
    jparams = jax.tree.map(np.asarray,
                           jmodel.init_params(jax.random.PRNGKey(0)))
    tmodel = t_build(t_reduced("libra-proxy-125m"), page_size=8)
    params = params_from_jax(jparams, tmodel, device="cpu")
    want = _printed(capsys, ref.serving_proxy)
    capsys.readouterr()
    eng = port.serving_proxy("cpu", params=params)
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert sum(line.startswith("req ") for line in got) == 8
    assert got[-1].startswith("stack counters (tokens): CopyCounters(")
    (jeng,) = jax_engines
    pages = [(e.pool.alloc.free_pages, e.pool.alloc.total_pages,
              len(e.pool.registry)) for e in (eng, jeng)]
    assert pages[0] == pages[1] == (3, 60, 0)


def _script(*args, **env):
    full = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [
        str(ROOT / "src"), os.environ.get("PYTHONPATH")])), **env)
    return subprocess.run([sys.executable, str(EXAMPLE), *args],
                          capture_output=True, text=True, env=full,
                          timeout=300)


def test_the_script_runs_on_the_cpu_when_asked():
    res = _script("--device", "cpu")
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0] == "--- stream proxy (3 protocols, 5 backends, one stack) ---"
    assert "--- serving proxy summary ---" in lines


def test_the_script_without_a_card_raises():
    res = _script(CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert res.stdout == ""
