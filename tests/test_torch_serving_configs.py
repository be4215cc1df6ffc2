"""The port's serving paths of the four configs that joined the dense
family's (minicpm-2b, mistral-nemo-12b) and the ``moe`` family
(qwen2-moe-a2.7b, qwen3-moe-30b-a3b) against the JAX package's, on the CPU.

Weights of each reduced config are made by the JAX package from a seed and
carried across with ``params_from_jax``; the same numpy-seeded prompts go
through ``repro`` and ``repro_torch``: ``TransformerLM.prefill`` /
``decode_step`` and ``prefill_dense`` / ``decode_step_dense`` (the JAX
model at ``compute_dtype=float32`` on a one-device mesh), ``LibraEngine``
for all four and, on qwen2-moe, ``StandardEngine``, ``CopierEngine`` and
``StaticEngine`` (``device="cpu"``). Tokens, ``EngineStats`` and
``CopyCounters`` must be identical (integers: exact equality), the KV pool,
cache and logits agree to ``atol = rtol = 1e-4`` (float32, several layers
of rounding). The MoE layers route every row of a call together, padded
prompt positions included, at the serving paths' capacity factor 2.0, as
the reference does. Also the launcher's report for ``--arch
qwen2-moe-a2.7b`` against the JAX launcher's."""
import contextlib
import dataclasses
import io
import os
import subprocess
import sys
from functools import lru_cache, partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.common.sharding import make_mesh
from repro.core.parser import TokenStreamParser as JParser
from repro.models import attention as jattn
from repro.models.registry import build_model as j_build
from repro.serving import engine as jengine
from repro_torch.core.anchor_pool import AnchorPool
from repro_torch.core.parser import TokenStreamParser as TParser
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model as t_build
from repro_torch.serving import engine as tengine

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["minicpm-2b", "mistral-nemo-12b", "qwen2-moe-a2.7b",
         "qwen3-moe-30b-a3b"]
MOE = "qwen2-moe-a2.7b"
PAGE = 8
CLASSES = {"libra": "LibraEngine", "standard": "StandardEngine",
           "copier": "CopierEngine", "static": "StaticEngine"}


@lru_cache(maxsize=None)
def _carry(arch):
    cfg = jconfigs.get_reduced(arch)
    jm = j_build(cfg, page_size=PAGE)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = t_build(tconfigs.get_reduced(arch), page_size=PAGE)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return arch, jm, jp, tm, tp


@pytest.fixture(scope="module", params=ARCHS)
def twin(request):
    """(arch, JAX model, JAX params, port model, port params) of the
    reduced config, the port's weights carried across from JAX's."""
    return _carry(request.param)


@pytest.fixture(scope="module")
def moe_twin():
    return _carry(MOE)


def _close(jax_out, torch_out):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out), **TOL)


def _jit_kw():
    """The JAX engine's jit arguments on a one-device mesh."""
    mesh = make_mesh((1, 1), ("data", "model"))
    b_axis, combine = jattn.plan_decode_sharding(2, mesh)
    return dict(mesh=mesh, batch_axis=b_axis, combine_axes=combine,
                compute_dtype=jnp.float32)


# ---------------------------------------------------------------------------
# TransformerLM: the Libra paths and the standard stack's
# ---------------------------------------------------------------------------

def test_prefill_and_decode_match_jax(twin):
    """Two prompts of 13 and 20 tokens (padded to 24: the MoE layers route
    the padding too), then three decode steps with the write page of each
    step grown as the engine grows it."""
    arch, jm, jp, tm, tp = twin
    cfg = tm.cfg
    rng = np.random.default_rng(7)
    lens = [13, 20]
    prompts = [rng.integers(1, cfg.vocab_size - 1, n) for n in lens]
    alloc = AnchorPool(1, 24, PAGE)
    seqs = [alloc.alloc_sequence(n + 3) for n in lens]
    s = -(-max(lens) // PAGE) * PAGE
    tokens = np.stack([np.pad(p, (0, s - len(p))) for p in prompts]
                      ).astype(np.int32)
    seq_lens = np.array(lens, np.int32)
    tables, page_pos = alloc.tables_for(seqs, 6)
    tc = alloc.token_coords(seqs, s)
    kw = _jit_kw()
    j_pool = jnp.zeros(jm.kv_pool_shape(alloc.total_pages), jnp.float32)
    t_pool = torch.zeros(tm.kv_pool_shape(alloc.total_pages))

    j_first, j_pool = jax.jit(partial(jm.prefill, **kw))(
        jp, tokens, seq_lens, j_pool, tables, *tc)
    t_first = tm.prefill(tp, torch.from_numpy(tokens),
                         torch.from_numpy(seq_lens), t_pool,
                         torch.from_numpy(tables), *map(torch.from_numpy, tc))
    assert t_first.tolist() == np.asarray(j_first).tolist()
    _close(j_pool, t_pool)

    j_dec = jax.jit(partial(jm.decode_step, **kw))
    cur = np.asarray(j_first).astype(np.int32)
    for step in range(3):
        pos = seq_lens + step
        wsh, wsl = AnchorPool.write_coords(seqs, pos.tolist(), 1, PAGE)
        args = (cur, pos.astype(np.int32), tables, page_pos, wsh, wsl)
        j_next, j_pool, _ = j_dec(jp, args[0], args[1], j_pool, *args[2:])
        t_next = tm.decode_step(tp, *map(torch.from_numpy, args[:2]), t_pool,
                                *map(torch.from_numpy, args[2:]))
        assert t_next.tolist() == np.asarray(j_next).tolist(), (arch, step)
        _close(j_pool, t_pool)
        cur = np.asarray(j_next).astype(np.int32)


def test_prefill_and_decode_dense_match_jax(twin):
    """The standard stack's paths: prompts of 5 and 13 tokens into a
    24-token cache, then three decode steps' full logits and caches."""
    _arch, jm, jp, tm, tp = twin
    rng = np.random.default_rng(11)
    lens = [5, 13]
    tokens = np.stack([np.pad(rng.integers(1, tm.cfg.vocab_size - 1, n),
                              (0, 13 - n)) for n in lens]).astype(np.int32)
    seq_lens = np.array(lens, np.int32)
    max_len = 24
    j_first, j_kv = jax.jit(lambda p, t, s: jm.prefill_dense(
        p, t, s, max_len, compute_dtype=jnp.float32))(jp, tokens, seq_lens)
    t_first, t_kv = tm.prefill_dense(tp, torch.from_numpy(tokens),
                                     torch.from_numpy(seq_lens), max_len)
    assert t_first.tolist() == np.asarray(j_first).tolist()
    _close(j_kv, t_kv)
    j_dec = jax.jit(lambda p, t, s, c: jm.decode_step_dense(
        p, t, s, c, compute_dtype=jnp.float32))
    j_cache, t_cache = j_kv, t_kv
    cur = np.asarray(j_first).astype(np.int32)
    for pos in ([5, 13], [6, 14], [7, 23]):
        pos = np.array(pos, np.int32)
        j_logits, j_cache = j_dec(jp, cur, pos, j_cache)
        t_logits, t_cache = tm.decode_step_dense(
            tp, torch.from_numpy(cur), torch.from_numpy(pos), t_cache)
        _close(j_logits, t_logits)
        _close(j_cache, t_cache)
        cur = np.asarray(j_logits).argmax(-1).astype(np.int32)
        assert t_logits.argmax(-1).tolist() == cur.tolist()


def test_moe_layers_route_every_row_in_one_call(moe_twin, monkeypatch):
    """One ``moe_ffn`` call a layer, over all ``B*S`` rows of a prefill
    (padding included) and all ``B`` rows of a decode step, at capacity
    factor 2.0."""
    _arch, _jm, _jp, tm, tp = moe_twin
    calls = []
    inner = tmoe.moe_ffn

    def counted(p, x, cfg, **kw):
        calls.append((tuple(x.shape), kw.get("capacity_factor")))
        return inner(p, x, cfg, **kw)

    monkeypatch.setattr(tmoe, "moe_ffn", counted)
    b, s, max_len = 3, 11, 16
    tokens = torch.arange(1, b * s + 1, dtype=torch.int32).reshape(b, s)
    seq_lens = torch.tensor([11, 4, 7], dtype=torch.int32)
    _first, kv = tm.prefill_dense(tp, tokens, seq_lens, max_len)
    tm.decode_step_dense(tp, tokens[:, 0], seq_lens, kv)
    d, layers = tm.cfg.d_model, tm.cfg.num_layers
    assert calls == [((b * s, d), 2.0)] * layers + [((b, d), 2.0)] * layers


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _assert_same(j, t, j_reqs, t_reqs):
    assert [r.output for r in t_reqs] == [r.output for r in j_reqs]
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    if isinstance(j, jengine.LibraEngine):
        assert dataclasses.asdict(t.stack.counters) == \
            dataclasses.asdict(j.stack.counters)
        _close(j.pool.pool, t.pool.pool)
        for e in (j, t):                 # every page but the parking page
            assert e.pool.alloc.free_pages == e.pool.alloc.total_pages - 1
    else:
        assert t.max_batch == j.max_batch
        _close(j.cache, t.cache)


def _serve(mp, name, n_req, gen, seed, **kw):
    _arch, jm, jp, tm, tp = mp
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 250, rng.integers(6, 20)) for _ in range(n_req)]
    engs = (getattr(jengine, CLASSES[name])(
                jm, jp, parser=JParser(header_len=4), **kw),
            getattr(tengine, CLASSES[name])(
                tm, tp, parser=TParser(header_len=4), device="cpu", **kw))
    reqs = [[e.submit(p, max_new_tokens=gen) for p in prompts] for e in engs]
    for e in engs:
        e.run()
    _assert_same(*engs, *reqs)
    assert all(len(r.output) == gen for r in reqs[1])


def test_libra_engine_matches_jax(twin):
    """Five requests over two slots: waves of admission, idle slots on the
    parking page."""
    _serve(twin, "libra", 5, 3, 5, max_batch=2, max_len=48, page_size=PAGE)


@pytest.mark.parametrize("name", ["standard", "copier", "static"])
def test_baseline_engines_serve_moe_as_jax(moe_twin, name):
    """qwen2-moe under the three baseline stacks: 4 requests over 2 slots
    (``static``: a budget of 2 slots)."""
    cfg = moe_twin[3].cfg
    max_len = 48
    kw = (dict(memory_budget=2 * cfg.num_layers * max_len * 2
               * cfg.num_kv_heads * cfg.head_dim * 4)
          if name == "static" else dict(max_batch=2))
    _serve(moe_twin, name, 4, 3, 21, max_len=max_len, **kw)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_serve_launcher_moe_reports_what_the_jax_launcher_reports():
    """``--arch qwen2-moe-a2.7b`` (reduced): the boundary-traffic and
    payload lines of both launchers are identical; throughput and latency
    are timings."""
    argv = ["--arch", MOE, "--requests", "3", "--prompt-len", "12",
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
    t_lines, j_lines = buf.getvalue().splitlines(), res.stdout.splitlines()
    assert len(t_lines) == len(j_lines) == 4
    assert t_lines[0] == j_lines[0] == "engine=libra batch=2 requests=3"
    assert t_lines[2:] == j_lines[2:]
    assert t_lines[1].startswith("throughput: ")


def test_registry_and_launcher_offer_the_four_configs():
    """The four configs are registered and served; the launcher serves
    hymba-1.5b and refuses xlstm-350m (no KV cache), internvl2-76b and
    whisper-medium (the engines feed no image or frames, as the JAX
    package's cannot: those two are driven through prefill / decode_step).
    """
    for arch in ARCHS + ["hymba-1.5b", "internvl2-76b", "whisper-medium"]:
        assert arch in tconfigs.ARCHS
    for arch in ("internvl2-76b", "whisper-medium"):
        with pytest.raises(SystemExit):
            tserve.main(["--arch", arch, "--device", "cpu"])
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "xlstm-350m", "--device", "cpu"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tserve.main(["--arch", "hymba-1.5b", "--requests", "2",
                     "--prompt-len", "12", "--gen", "2", "--batch", "2",
                     "--device", "cpu"])
    assert buf.getvalue().splitlines()[0] == \
        "engine=libra batch=2 requests=2"
