"""The port's serving slice against the JAX package's, on the CPU.

Weights are made by the JAX package from a seed and carried across with
``params_from_jax``; the same numpy-seeded prompts then go through
``repro`` and ``repro_torch``: ``TransformerLM.prefill`` / ``decode_step``
and ``LibraEngine`` (``device="cpu"``) of the reduced ``phi4-mini-3.8b``
(GQA 4/2) and ``libra-proxy-125m``. Tokens, ``EngineStats`` and
``CopyCounters`` must be identical (integers: exact equality) and the KV
pool must agree to ``atol = rtol = 1e-4`` (float32). Also the configs and
parameter counts, the launcher's report, and the no-silent-CPU rule."""
import contextlib
import dataclasses
import io
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _configs import assert_config_matches_jax

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.common.sharding import make_mesh
from repro.core.parser import TokenStreamParser as JParser
from repro.models import attention as jattn
from repro.models.registry import build_model as j_build
from repro.serving.engine import LibraEngine as JEngine
from repro_torch.common.types import ModelConfig
from repro_torch.core.anchor_pool import AnchorPool
from repro_torch.core.parser import TokenStreamParser as TParser
from repro_torch.launch import serve as tserve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model as t_build
from repro_torch.serving.engine import LibraEngine as TEngine

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["phi4-mini-3.8b", "libra-proxy-125m"]
PAGE = 8


@pytest.fixture(scope="module", params=ARCHS)
def twin(request):
    """(arch, JAX model, JAX params, port model, port params) of the
    reduced config, the port's weights carried across from JAX's."""
    cfg = jconfigs.get_reduced(request.param)
    jm = j_build(cfg, page_size=PAGE)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = t_build(tconfigs.get_reduced(request.param), page_size=PAGE)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return request.param, jm, jp, tm, tp


def _close(jax_out, torch_out):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out),
                               **TOL)


# ---------------------------------------------------------------------------
# configs, templates, parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "phi3-mini-3.8b",
                                  "libra-proxy-125m", "minicpm-2b",
                                  "mistral-nemo-12b", "qwen2-moe-a2.7b",
                                  "qwen3-moe-30b-a3b", "hymba-1.5b"])
def test_configs_and_param_counts_match_jax(arch):
    for get in ("get_config", "get_reduced"):
        j, t = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        assert_config_matches_jax(j, t)
    full = tconfigs.get_config(arch)
    assert full.param_count() == jconfigs.get_config(arch).param_count()
    if arch == "phi4-mini-3.8b":
        assert round(full.param_count() / 1e9, 2) == 3.84


@pytest.mark.parametrize("family", ["vlm", "encdec"])
def test_every_family_builds_and_every_config_matches_jax(family):
    """``build_model`` gives a ``TransformerLM`` under ``vlm`` and an
    ``EncDecModel`` under ``encdec``; ``get_config`` / ``get_reduced`` of
    every arch of the JAX package's registry, in its order, equal the
    reference's."""
    from repro_torch.models.encdec import EncDecModel
    from repro_torch.models.transformer import TransformerLM

    cfg = ModelConfig(name=f"x-{family}", family=family, num_layers=1,
                      d_model=8, num_heads=2, num_kv_heads=2, d_ff=8,
                      vocab_size=16, img_tokens=2, enc_layers=1,
                      enc_frames=4)
    want = {"vlm": TransformerLM, "encdec": EncDecModel}[family]
    assert type(t_build(cfg)) is want
    assert tconfigs.ARCHS == jconfigs.ARCHS
    for arch in jconfigs.ARCHS:
        for get in ("get_config", "get_reduced"):
            assert_config_matches_jax(getattr(jconfigs, get)(arch),
                                      getattr(tconfigs, get)(arch))
    assert {a for a, c in tconfigs.all_configs().items()
            if c.family == family} == \
        {a for a, c in jconfigs.all_configs().items() if c.family == family}


@pytest.mark.parametrize("arch", jconfigs.ARCHS + ["libra-proxy-125m"])
def test_param_counts_and_active_param_counts_match_jax(arch):
    """``count_params_from_config`` with and without ``active_only`` and
    ``ModelConfig.active_param_count`` equal the reference's for every
    arch (a moe config counts only its top-k routed experts)."""
    from repro.models.registry import count_params_from_config as j_count
    from repro_torch.models.registry import count_params_from_config as t_count

    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for active in (False, True):
        assert t_count(t, active_only=active) == j_count(j, active_only=active)
    assert t.active_param_count() == j.active_param_count()
    assert (t.active_param_count() < t.param_count()) == (t.family == "moe")


def test_init_params_is_seeded_and_follows_the_template():
    m = t_build(tconfigs.get_reduced("phi4-mini-3.8b"), page_size=PAGE)
    a, b = m.init_params(3, device="cpu"), m.init_params(3, device="cpu")
    c = m.init_params(4, device="cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])
    assert torch.count_nonzero(a["final_norm"]) == 0       # (1 + w), w = 0
    assert tuple(a["layers"]["mlp"]["w_down"].shape) == (2, 128, 64)
    emb = a["embed"]                                       # std 1/sqrt(D)
    assert abs(emb.std().item() * 64 ** 0.5 - 1) < 0.05


def test_params_from_jax_checks_keys_and_shapes(twin):
    _arch, _jm, jp, tm, _tp = twin
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="extra"):
        params_from_jax(bad, tm, device="cpu")
    bad = dict(tree, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, tm, device="cpu")


# ---------------------------------------------------------------------------
# TransformerLM.prefill / decode_step
# ---------------------------------------------------------------------------

def _jit_kw():
    """The JAX engine's jit arguments on a one-device mesh."""
    mesh = make_mesh((1, 1), ("data", "model"))
    b_axis, combine = jattn.plan_decode_sharding(2, mesh)
    return dict(mesh=mesh, batch_axis=b_axis, combine_axes=combine,
                compute_dtype=jnp.float32)


def test_prefill_and_decode_match_jax(twin):
    """Two prompts of 13 and 20 tokens: prefill, then three decode steps
    with the write page of each step grown as the engine grows it."""
    arch, jm, jp, tm, tp = twin
    cfg = tm.cfg
    rng = np.random.default_rng(7)
    lens = [13, 20]
    prompts = [rng.integers(1, cfg.vocab_size - 1, n) for n in lens]
    alloc = AnchorPool(1, 24, PAGE)
    seqs = [alloc.alloc_sequence(n + 3) for n in lens]
    pps = 6
    s = -(-max(lens) // PAGE) * PAGE
    tokens = np.stack([np.pad(p, (0, s - len(p))) for p in prompts]
                      ).astype(np.int32)
    seq_lens = np.array(lens, np.int32)
    tables, page_pos = alloc.tables_for(seqs, pps)
    tc = alloc.token_coords(seqs, s)
    kw = _jit_kw()
    j_pool = jnp.zeros(jm.kv_pool_shape(alloc.total_pages), jnp.float32)
    t_pool = torch.zeros(tm.kv_pool_shape(alloc.total_pages))

    j_first, j_pool = jax.jit(partial(jm.prefill, **kw))(
        jp, tokens, seq_lens, j_pool, tables, *tc)
    t_first = tm.prefill(tp, *map(torch.from_numpy,
                                  (tokens, seq_lens)), t_pool,
                         torch.from_numpy(tables),
                         *map(torch.from_numpy, tc))
    assert t_first.dtype == torch.int32
    assert t_first.tolist() == np.asarray(j_first).tolist()
    _close(j_pool, t_pool)

    j_dec = jax.jit(partial(jm.decode_step, **kw))
    cur = np.asarray(j_first).astype(np.int32)
    for step in range(3):
        pos = seq_lens + step
        wsh, wsl = AnchorPool.write_coords(seqs, pos.tolist(), 1, PAGE)
        args = (cur, pos.astype(np.int32), tables, page_pos, wsh, wsl)
        j_next, j_pool, _ = j_dec(jp, args[0], args[1], j_pool, *args[2:])
        t_next = tm.decode_step(tp, torch.from_numpy(args[0]),
                                torch.from_numpy(args[1]), t_pool,
                                *map(torch.from_numpy, args[2:]))
        assert t_next.tolist() == np.asarray(j_next).tolist(), (arch, step)
        _close(j_pool, t_pool)
        cur = np.asarray(j_next).astype(np.int32)


# ---------------------------------------------------------------------------
# LibraEngine
# ---------------------------------------------------------------------------

def _engines(twin, **kw):
    _arch, jm, jp, tm, tp = twin
    return (JEngine(jm, jp, page_size=PAGE, parser=JParser(header_len=4),
                    **kw),
            TEngine(tm, tp, page_size=PAGE, parser=TParser(header_len=4),
                    device="cpu", **kw))


@pytest.mark.parametrize("n_req,max_batch,gen", [(3, 3, 5), (5, 2, 3),
                                                 (2, 2, 1)])
def test_libra_engine_matches_jax(twin, n_req, max_batch, gen):
    """Waves of admission (more requests than slots), idle slots on the
    parking page, and requests that complete at prefill."""
    rng = np.random.default_rng(n_req)
    prompts = [rng.integers(1, 250, rng.integers(6, 20)) for _ in range(n_req)]
    engs = _engines(twin, max_batch=max_batch, max_len=64)
    reqs = [[e.submit(p, max_new_tokens=gen) for p in prompts] for e in engs]
    for e in engs:
        e.run()
    assert [r.output for r in reqs[0]] == [r.output for r in reqs[1]]
    assert all(len(r.output) == gen for r in reqs[1])
    j, t = engs
    assert dataclasses.asdict(j.stats) == dataclasses.asdict(t.stats)
    assert dataclasses.asdict(j.stack.counters) == \
        dataclasses.asdict(t.stack.counters)
    _close(j.pool.pool, t.pool.pool)
    for e in engs:                       # every page but the parking page
        assert e.pool.alloc.free_pages == e.pool.alloc.total_pages - 1
        assert len(e.pool.registry) == 0


def test_libra_engine_forwarding_matches_jax(twin):
    """Zero-copy handoff: a shared handle keeps its pages after release."""
    rng = np.random.default_rng(9)
    prompt = rng.integers(1, 250, 12)
    engs = _engines(twin, max_batch=2, max_len=64)
    for e in engs:
        r = e.submit(prompt, max_new_tokens=5)
        e.step()
        h = e.forward_handle(r)
        before = e.pool.alloc.free_pages
        e.release_handle(h)
        assert e.pool.alloc.free_pages == before
        e.run()
    j, t = engs
    assert dataclasses.asdict(j.stats) == dataclasses.asdict(t.stats)
    assert dataclasses.asdict(j.stack.counters) == \
        dataclasses.asdict(t.stack.counters)
    assert j.completed[0].output == t.completed[0].output


def test_anchored_bytes_count_past_int32(twin, monkeypatch):
    """A wave of 8192 phi4-mini prompt tokens anchors 2 GiB of KV: the
    count stays exact (the JAX engine's int32 product wraps there)."""
    _arch, _jm, _jp, tm, tp = twin
    eng = TEngine(tm, tp, page_size=PAGE, max_batch=2, max_len=32,
                  device="cpu")
    monkeypatch.setattr(eng, "_kv_bytes_per_token", lambda: 1 << 30)
    eng.submit(np.arange(1, 6), max_new_tokens=1)
    eng.submit(np.arange(1, 4), max_new_tokens=1)
    eng.run()
    assert eng.stats.anchored_bytes == 8 << 30


def test_engine_on_cuda_without_gpu_raises(twin):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU rule cannot be exercised")
    _arch, _jm, _jp, tm, tp = twin
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(tm, tp, page_size=PAGE, max_batch=2, max_len=32)


def test_engine_refuses_a_model_of_another_page_size(twin):
    _arch, _jm, _jp, tm, tp = twin
    with pytest.raises(ValueError, match="pages hold"):
        TEngine(tm, tp, page_size=2 * PAGE, max_batch=2, max_len=32,
                device="cpu")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launcher_lines(engine):
    """The port's and the JAX launcher's report of the same requests under
    ``engine``; the JAX launcher runs as its own process, as its entry
    point is run."""
    argv = ["--engine", engine, "--requests", "3", "--prompt-len", "12",
            "--gen", "3", "--batch", "2"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tserve.main(argv + ["--device", "cpu"])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(filter(None, [
                   str(ROOT / "src"), os.environ.get("PYTHONPATH")])))
    res = subprocess.run([sys.executable, "-m", "repro.launch.serve", *argv],
                         capture_output=True, text=True, env=env, timeout=300,
                         check=True)
    return buf.getvalue().splitlines(), res.stdout.splitlines()


def test_serve_launcher_reports_what_the_jax_launcher_reports():
    """Same requests, same engine geometry: the boundary-traffic and
    payload lines are identical; throughput and latency are timings."""
    t_lines, j_lines = _launcher_lines("libra")
    assert len(t_lines) == len(j_lines) == 4
    assert t_lines[0] == j_lines[0] == "engine=libra batch=2 requests=3"
    assert t_lines[2:] == j_lines[2:]
    assert t_lines[1].startswith("throughput: ")


@pytest.mark.parametrize("engine", ["standard", "copier", "static"])
def test_serve_launcher_baselines_report_what_the_jax_launcher_reports(
        engine):
    """The same for the baseline engines: ``static`` takes its batch from
    the 256 MiB budget in both launchers."""
    t_lines, j_lines = _launcher_lines(engine)
    assert len(t_lines) == len(j_lines) == 4
    assert t_lines[0] == j_lines[0]
    assert t_lines[0].startswith(f"engine={engine} batch=")
    assert t_lines[0].endswith(" requests=3")
    assert t_lines[2:] == j_lines[2:]
    assert t_lines[1].startswith("throughput: ")
    assert not t_lines[3].startswith("payload: copied=0.00MB")


def test_serve_launcher_flags():
    with pytest.raises(SystemExit):
        tserve.main(["--engine", "fstack", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["--no-reduced", "--arch", "phi4-mini-3.8b"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["--engine", "static"])
