"""``scripts/check_bench_trend_torch.py`` in a temporary git repository on
the CPU: a committed baseline, then fresh artifacts.

* 40 % below the baseline, and still below it on the confirmation re-run
  (``benchmarks_torch.run --only <bench>`` on the CPU): the gate fails.
* Below the baseline, but not on the re-run: noise, a warning.
* A smoke artifact against a full baseline: a warning only.
* An artifact with no committed baseline: a warning only.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = "batched_datapath"
ROW = "batched_datapath_c8_batched_counters"


def _git(repo, *args):
    subprocess.run(["git", *args], cwd=repo, check=True, capture_output=True,
                   env={**os.environ, "GIT_AUTHOR_NAME": "t",
                        "GIT_AUTHOR_EMAIL": "t@t", "GIT_COMMITTER_NAME": "t",
                        "GIT_COMMITTER_EMAIL": "t@t"})


def _artifact(path, msgs_per_s, smoke=True, bench=BENCH):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"bench": bench, "smoke": smoke, "rows": [
        {"name": ROW, "msgs_per_s": msgs_per_s, "derived": ""}]}))


@pytest.fixture
def repo(tmp_path):
    """A git repository holding the gate, links to the port's packages and
    a committed baseline of ``BENCH_batched_datapath.json``."""
    (tmp_path / "scripts").mkdir()
    shutil.copy(ROOT / "scripts" / "check_bench_trend_torch.py",
                tmp_path / "scripts")
    (tmp_path / "src").mkdir()
    os.symlink(ROOT / "src" / "repro_torch", tmp_path / "src" / "repro_torch")
    os.symlink(ROOT / "benchmarks_torch", tmp_path / "benchmarks_torch")
    _git(tmp_path, "init", "-q")
    return tmp_path


def _gate(repo):
    return subprocess.run(
        [sys.executable, "scripts/check_bench_trend_torch.py", "--device",
         "cpu"], cwd=repo, capture_output=True, text=True, timeout=300)


def _commit_baseline(repo, msgs_per_s, smoke=True):
    art = repo / "results" / "bench_torch" / f"BENCH_{BENCH}.json"
    _artifact(art, msgs_per_s, smoke=smoke)
    _git(repo, "add", "-A")
    _git(repo, "commit", "-q", "-m", "baseline")
    return art


def test_a_confirmed_regression_fails(repo):
    # a baseline no CPU run reaches, so the confirmation run regresses too
    art = _commit_baseline(repo, 1e12)
    _artifact(art, 0.6e12)
    res = _gate(repo)
    assert res.returncode == 1, res.stdout + res.stderr
    assert f"RETRY results/bench_torch/BENCH_{BENCH}.json" in res.stdout
    assert f"FAIL  results/bench_torch/BENCH_{BENCH}.json: {ROW}.msgs_per_s" \
        in res.stdout
    # the confirmation run refreshed the artifact with a real measurement
    fresh = json.loads(art.read_text())
    assert fresh["smoke"] is True and len(fresh["rows"]) > 1
    assert 0 < next(r for r in fresh["rows"]
                    if r["name"] == ROW)["msgs_per_s"] < 1e12


def test_a_regression_gone_on_the_rerun_is_noise(repo):
    art = _commit_baseline(repo, 1.0)
    _artifact(art, 0.6)
    res = _gate(repo)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "recovered on re-run (noise)" in res.stdout


def test_a_smoke_full_mismatch_only_warns(repo):
    art = _commit_baseline(repo, 1e12, smoke=False)
    _artifact(art, 0.6e12, smoke=True)
    res = _gate(repo)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "smoke-mode mismatch" in res.stdout and "RETRY" not in res.stdout


def test_a_new_artifact_only_warns(repo):
    _commit_baseline(repo, 1.0)
    _artifact(repo / "results" / "bench_torch" / "BENCH_new.json", 5.0,
              bench="new")
    res = _gate(repo)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BENCH_new.json: no committed baseline (new benchmark)" \
        in res.stdout
