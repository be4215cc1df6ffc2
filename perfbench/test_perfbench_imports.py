"""What the benchmark loads: no JAX and no JAX package in a run, nothing of
the port in a reference, and no result without a card."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _python(code: str, **env) -> subprocess.CompletedProcess:
    e = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env)
    e.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=e,
                          capture_output=True, text=True, timeout=300)


def test_a_run_loads_no_jax_and_no_jax_package():
    res = _python(
        "import json, sys\n"
        "from perfbench import run, testing\n"
        "testing.serve_cpu(testing.tiny_config('phi4-mini-3.8b'),"
        " testing.tiny_mix(), 3)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert res.returncode == 0, res.stderr[-2000:]
    names = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in names
    assert not names & FORBIDDEN


@pytest.mark.parametrize("family", ["dense"])
def test_a_reference_loads_nothing_of_the_port(family):
    res = _python(f"import sys; import perfbench.reference.{family}\n"
                  "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert res.returncode == 0, res.stderr[-2000:]
    assert "repro_torch" not in res.stdout and "'repro'" not in res.stdout
    allowed = {"__future__", "contextlib", "math", "typing", "numpy", "torch",
               "perfbench"}
    for path in (HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert tops <= allowed, (path.name, tops)


def test_forbidden_names_are_compared_whole():
    from perfbench import run

    assert run.forbidden_modules(["repro_torch.models", "jaxtyping",
                                  "reprocess", "torch"]) == []
    assert run.forbidden_modules(["repro.core", "jax.numpy",
                                  "flax"]) == ["flax", "jax", "repro"]


def test_no_card_no_result():
    res = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "phi4-mini-3.8b.chat", "--seed", str(2 ** 31 + 1), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 3
    assert res.stdout.strip() == ""
