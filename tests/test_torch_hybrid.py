"""The port's ``hybrid`` family (hymba) against the JAX package's, on the CPU.

Weights of ``hymba-reduced`` (2 layers, layer 0 global, layer 1 windowed
over 16 positions; GQA 4/2; Mamba state 8) are made by the JAX package from
a seed and carried across with ``params_from_jax``; the same numpy-seeded
inputs then go through ``repro`` and ``repro_torch``: ``layer_groups``, the
Mamba mixer (``selective_scan_chunked``, ``mamba_forward``,
``mamba_step``), windowed ``prefill_attention`` and
``paged_decode_attention``, ``TransformerLM.prefill`` / ``decode_step``
with its ``ssm_state``, and ``LibraEngine`` (``device="cpu"``) with
prompts longer than the window. Tokens, ``EngineStats`` and
``CopyCounters`` must be identical (integers: exact equality); the mixer
agrees to ``atol = rtol = 1e-5`` (its scan adds in another order than the
reference's ``associative_scan``), the pool and ``ssm_state`` after whole
layers to ``1e-4``. Also the two faults of the reference the port carries
verbatim: a request's decode starts from whatever SSM state its batch row
held (F1), and the baseline engines serve the model without its SSM
branch and windows (F2)."""
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

from _configs import assert_config_matches_jax

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.common.sharding import make_mesh
from repro.core.parser import TokenStreamParser as JParser
from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro.models import transformer as jtrans
from repro.models.registry import build_model as j_build
from repro.serving import engine as jengine
from repro_torch.core.anchor_pool import AnchorPool
from repro_torch.core.parser import TokenStreamParser as TParser
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttrans
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model as t_build
from repro_torch.serving import engine as tengine

ROOT = Path(__file__).resolve().parents[1]
ARCH = "hymba-1.5b"
PAGE = 8
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
#: the reference's parameter count of the published config
HYMBA_PARAMS = 1_662_264_000


def _close(jax_out, torch_out, tol=TOL):
    np.testing.assert_allclose(torch_out.detach().numpy(),
                               np.asarray(jax_out), **tol)


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@lru_cache(maxsize=None)
def _carry():
    cfg = jconfigs.get_reduced(ARCH)
    jm = j_build(cfg, page_size=PAGE)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = t_build(tconfigs.get_reduced(ARCH), page_size=PAGE)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def twin():
    """(JAX model, JAX params, port model, port params) of hymba-reduced,
    the port's weights carried across from JAX's."""
    return _carry()


def _ssm_params(twin, layer=0):
    """One layer's Mamba parameters, JAX and port."""
    _jm, jp, _tm, tp = twin
    return (jax.tree.map(lambda a: a[layer], jp["layers"]["ssm"]),
            {k: v[layer] for k, v in tp["layers"]["ssm"].items()})


def _jit_kw(b=2):
    """The JAX engine's jit arguments on a one-device mesh."""
    mesh = make_mesh((1, 1), ("data", "model"))
    b_axis, combine = jattn.plan_decode_sharding(b, mesh)
    return dict(mesh=mesh, batch_axis=b_axis, combine_axes=combine,
                compute_dtype=jnp.float32)


# ---------------------------------------------------------------------------
# config, parameters, layer groups
# ---------------------------------------------------------------------------

def test_config_and_param_count_match_jax():
    for get in ("get_config", "get_reduced"):
        j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        assert_config_matches_jax(j, t)
    full = tconfigs.get_config(ARCH)
    assert full.param_count() == jconfigs.get_config(ARCH).param_count() \
        == HYMBA_PARAMS
    assert t_build(tconfigs.get_reduced(ARCH)).param_count() == \
        j_build(jconfigs.get_reduced(ARCH)).param_count()


def _cfg_variants():
    full = tconfigs.get_config(ARCH)
    return {"full": full, "reduced": tconfigs.get_reduced(ARCH),
            "no-globals": dataclasses.replace(full, global_attn_layers=()),
            "globals-at-ends": dataclasses.replace(
                full, num_layers=6, global_attn_layers=(5, 0)),
            "dense": tconfigs.get_config("phi4-mini-3.8b")}


@pytest.mark.parametrize("variant", list(_cfg_variants()))
def test_layer_groups_match_jax(variant):
    cfg = _cfg_variants()[variant]
    jbase = jconfigs.get_config(ARCH)
    jcfg = jconfigs.get_config(cfg.name) if variant == "dense" else \
        dataclasses.replace(jbase, **{f.name: getattr(cfg, f.name)
                                      for f in dataclasses.fields(jbase)})
    want = [(g.start, g.end, g.window) for g in jtrans.layer_groups(jcfg)]
    got = [(g.start, g.end, g.window) for g in ttrans.layer_groups(cfg)]
    assert got == want
    windows = ttrans.layer_windows(cfg)
    assert len(windows) == cfg.num_layers
    assert [windows[s] for s, _e, _w in got] == [w for _s, _e, w in got]
    if variant == "full":       # 0 global, 1-14 windowed, 15, 16-30, 31
        assert got == [(0, 1, 0), (1, 15, 1024), (15, 16, 0),
                       (16, 31, 1024), (31, 32, 0)]
        assert windows.count(1024) == 29


def test_hybrid_template_and_ssm_state_shapes(twin):
    _jm, _jp, tm, tp = twin
    c = tm.cfg
    assert set(tp["layers"]) >= {"ssm", "attn_branch_norm",
                                 "ssm_branch_norm"}
    d_inner = c.ssm_expand * c.d_model
    assert tm.ssm_state_shapes(3) == {
        "ssm": (c.num_layers, 3, d_inner, c.ssm_state),
        "conv": (c.num_layers, 3, c.ssm_conv - 1, d_inner)}
    assert tm.windows == [0, 16]


# ---------------------------------------------------------------------------
# the Mamba mixer
# ---------------------------------------------------------------------------

def _scan_inputs(seed, b, s, d, n, with_h0):
    rng = np.random.default_rng(seed)
    u = _rand(rng, (b, s, d))
    dt = np.log1p(np.exp(_rand(rng, (b, s, d)))).astype(np.float32)
    bc, cc = _rand(rng, (b, s, n)), _rand(rng, (b, s, n))
    a = (-np.exp(_rand(rng, (d, n), 0.5))).astype(np.float32)
    h0 = _rand(rng, (b, d, n)) if with_h0 else None
    return u, dt, bc, cc, a, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,d,n,chunk", [(2, 300, 16, 8, 128),
                                           (1, 37, 8, 4, 16),
                                           (3, 128, 32, 16, 128),
                                           (2, 5, 8, 4, 128)])
def test_selective_scan_chunked_matches_jax(b, s, d, n, chunk, with_h0):
    """Chunks of ``chunk`` positions, ``S`` a multiple of it or not (the
    reference pads the last chunk, the port shortens it); from a given
    state or from zero."""
    u, dt, bc, cc, a, h0 = _scan_inputs(s + d, b, s, d, n, with_h0)
    jy, jh = jssm.selective_scan_chunked(u, dt, bc, cc, a, h0=h0,
                                         chunk=chunk)
    ty, th = tssm.selective_scan_chunked(
        *map(torch.from_numpy, (u, dt, bc, cc, a)),
        h0=None if h0 is None else torch.from_numpy(h0), chunk=chunk)
    assert tuple(ty.shape) == (b, s, d) and tuple(th.shape) == (b, d, n)
    _close(jy, ty, SCAN_TOL)
    _close(jh, th, SCAN_TOL)


def test_doubling_scan_equals_a_sequential_recurrence():
    """The chunk scan is the recurrence h_t = a_t h_(t-1) + b_t from zero,
    with a_s the running product of the decays."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(np.exp(-np.abs(_rand(rng, (2, 37, 5)))))
    b = torch.from_numpy(_rand(rng, (2, 37, 5)))
    a_s, b_s = tssm._doubling_scan(a, b)
    h, p = torch.zeros(2, 5), torch.ones(2, 5)
    for t in range(37):
        h, p = a[:, t] * h + b[:, t], a[:, t] * p
        torch.testing.assert_close(b_s[:, t], h, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(a_s[:, t], p, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("s", [40, 200])
def test_mamba_forward_matches_jax(twin, s):
    """The full-sequence mixer on layer 1's parameters (``A_log``,
    ``dt_bias`` and ``conv_b`` drawn away from their zero init, so every
    term counts); 200 positions take two chunks."""
    jpl, tpl = _ssm_params(twin, 1)
    rng = np.random.default_rng(s)
    extra = {k: _rand(rng, np.shape(jpl[k]), 0.5)
             for k in ("A_log", "dt_bias", "conv_b")}
    jpl = dict(jpl, **extra)
    tpl = dict(tpl, **{k: torch.from_numpy(v) for k, v in extra.items()})
    x = _rand(rng, (2, s, twin[2].cfg.d_model))
    _close(jssm.mamba_forward(jpl, x), tssm.mamba_forward(
        tpl, torch.from_numpy(x)), SCAN_TOL)


def test_mamba_step_matches_jax(twin):
    """Five decode steps from a random state; the step returns a new
    state and leaves its input as it was."""
    jpl, tpl = _ssm_params(twin, 0)
    c = twin[2].cfg
    shapes = tssm.mamba_state_shape(c.d_model, c.ssm_state, c.ssm_conv,
                                    c.ssm_expand)
    rng = np.random.default_rng(8)
    jst = {k: _rand(rng, (3,) + s) for k, s in shapes.items()}
    tst = {k: torch.from_numpy(v.copy()) for k, v in jst.items()}
    for _ in range(5):
        x = _rand(rng, (3, c.d_model))
        j_out, jst = jssm.mamba_step(jpl, x, jst)
        before = {k: v.clone() for k, v in tst.items()}
        t_out, new = tssm.mamba_step(tpl, torch.from_numpy(x), tst)
        assert all(torch.equal(before[k], tst[k]) for k in tst)
        tst = new
        _close(j_out, t_out, SCAN_TOL)
        for k in shapes:
            _close(jst[k], tst[k], SCAN_TOL)


# ---------------------------------------------------------------------------
# windowed attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 1, 5, 16, 40])
def test_windowed_prefill_attention_matches_jax(window):
    """``prefill_attention(window=)`` computes what the JAX model's
    ``dense_attention(causal=True, window=)`` does at ``arange(S)``:
    query i keeps keys with ``i - j < window``."""
    rng = np.random.default_rng(window)
    s = 37
    q, k, v = _rand(rng, (2, s, 4, 16)), _rand(rng, (2, s, 2, 16)), \
        _rand(rng, (2, s, 2, 16))
    pos = np.broadcast_to(np.arange(s), (2, s)).astype(np.int32)
    _close(jattn.dense_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                 causal=True, window=window),
           tattn.prefill_attention(*map(torch.from_numpy, (q, k, v)),
                                   window=window))


@pytest.mark.parametrize("window", [0, 1, 7, 16])
def test_windowed_paged_decode_attention_matches_jax(window):
    """Write the new token's K/V and attend over the pages within the
    window, ``seq_lens - pos < window``; output and pool must agree."""
    rng = np.random.default_rng(10 + window)
    b, hq, hkv, hd, page, pps, p_total = 3, 4, 2, 16, 8, 5, 16
    q = _rand(rng, (b, hq, hd))
    k_new, v_new = _rand(rng, (b, hkv, hd)), _rand(rng, (b, hkv, hd))
    pool = _rand(rng, (p_total, page, 2, hkv, hd))
    seq = np.array([19, 3, 33], np.int32)
    tables = np.array([[[3, 5, 7, -1, -1]], [[9, -1, -1, -1, -1]],
                       [[0, 1, 2, 4, 6]]], np.int32)
    page_pos = np.array([[[0, 8, 16, -1, -1]], [[0, -1, -1, -1, -1]],
                         [[0, 8, 16, 24, 32]]], np.int32)
    wsh = np.zeros(b, np.int32)
    wsl = np.array([2, 0, 4], np.int32)
    args = (q, k_new, v_new, pool, tables, page_pos, seq, wsh, wsl)
    j_out, j_pool = jattn.paged_decode_attention(
        *map(jnp.asarray, args), window=window,
        **{k: v for k, v in _jit_kw(b).items() if k != "compute_dtype"})
    t_args = list(map(torch.from_numpy, args))
    t_out = tattn.paged_decode_attention(*t_args, window=window)
    _close(j_out, t_out)
    _close(j_pool, t_args[3])                  # the pool, updated in place


# ---------------------------------------------------------------------------
# TransformerLM.prefill / decode_step
# ---------------------------------------------------------------------------

def test_prefill_and_decode_match_jax(twin):
    """Prompts of 21 and 30 tokens (past the window of 16): first tokens
    and pool pages, then four decode steps from a random SSM state:
    tokens, pages and the state, which the port advances in place."""
    jm, jp, tm, tp = twin
    cfg = tm.cfg
    rng = np.random.default_rng(7)
    lens = [21, 30]
    prompts = [rng.integers(1, cfg.vocab_size - 1, n) for n in lens]
    alloc = AnchorPool(1, 24, PAGE)
    seqs = [alloc.alloc_sequence(n + 4) for n in lens]
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

    j_st = {k: _rand(rng, s_, 0.5)
            for k, s_ in tm.ssm_state_shapes(2).items()}
    t_st = {k: torch.from_numpy(v.copy()) for k, v in j_st.items()}
    ptrs = {k: v.data_ptr() for k, v in t_st.items()}
    j_dec = jax.jit(partial(jm.decode_step, **kw))
    cur = np.asarray(j_first).astype(np.int32)
    for step in range(4):
        pos = seq_lens + step
        wsh, wsl = AnchorPool.write_coords(seqs, pos.tolist(), 1, PAGE)
        args = (cur, pos.astype(np.int32), tables, page_pos, wsh, wsl)
        j_next, j_pool, j_st = j_dec(jp, args[0], args[1], j_pool, *args[2:],
                                     ssm_state=j_st)
        t_next = tm.decode_step(tp, *map(torch.from_numpy, args[:2]), t_pool,
                                *map(torch.from_numpy, args[2:]),
                                ssm_state=t_st)
        assert t_next.tolist() == np.asarray(j_next).tolist(), step
        _close(j_pool, t_pool)
        for k in t_st:
            _close(j_st[k], t_st[k])
            assert t_st[k].data_ptr() == ptrs[k]          # in place
        cur = np.asarray(j_next).astype(np.int32)


def test_decode_step_takes_ssm_state_under_hybrid_only(twin):
    _jm, _jp, tm, tp = twin
    b = 2
    args = (torch.zeros(b, dtype=torch.int32), torch.zeros(b, dtype=torch.int32),
            torch.zeros(tm.kv_pool_shape(4)),
            torch.zeros((b, 1, 2), dtype=torch.int32),
            torch.zeros((b, 1, 2), dtype=torch.int32),
            torch.zeros(b, dtype=torch.int32),
            torch.zeros(b, dtype=torch.int32))
    with pytest.raises(ValueError, match="ssm_state"):
        tm.decode_step(tp, *args)
    dense = t_build(tconfigs.get_reduced("phi4-mini-3.8b"), page_size=PAGE)
    dp = dense.init_params(0, device="cpu")
    args = args[:2] + (torch.zeros(dense.kv_pool_shape(4)),) + args[3:]
    with pytest.raises(ValueError, match="ssm_state"):
        dense.decode_step(dp, *args, ssm_state={})


def test_prefill_attends_with_each_layers_window(twin, monkeypatch):
    """Layer 0 is global, layer 1 windowed over 16: each prefill and decode
    step passes its layer's window to the attention path."""
    _jm, _jp, tm, tp = twin
    seen = []
    for name in ("prefill_attention", "paged_decode_attention"):
        inner = getattr(tattn, name)

        def spy(*a, _inner=inner, _name=name, **kw):
            seen.append((_name, kw["window"]))
            return _inner(*a, **kw)
        monkeypatch.setattr(tattn, name, spy)
    eng = tengine.LibraEngine(tm, tp, page_size=PAGE, max_batch=1,
                              max_len=40, parser=TParser(header_len=4),
                              device="cpu")
    eng.submit(np.arange(1, 21), max_new_tokens=2)
    eng.run()
    assert seen == [("prefill_attention", 0), ("prefill_attention", 16),
                    ("paged_decode_attention", 0),
                    ("paged_decode_attention", 16)]


# ---------------------------------------------------------------------------
# LibraEngine
# ---------------------------------------------------------------------------

def _engines(twin, **kw):
    jm, jp, tm, tp = twin
    return (jengine.LibraEngine(jm, jp, page_size=PAGE,
                                parser=JParser(header_len=4), **kw),
            tengine.LibraEngine(tm, tp, page_size=PAGE,
                                parser=TParser(header_len=4), device="cpu",
                                **kw))


def _run_pair(twin, prompts, gens, **kw):
    engs = _engines(twin, **kw)
    reqs = [[e.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
            for e in engs]
    for e in engs:
        e.run()
    j, t = engs
    assert [r.output for r in reqs[1]] == [r.output for r in reqs[0]]
    assert [len(r.output) for r in reqs[1]] == list(gens)
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert dataclasses.asdict(t.stack.counters) == \
        dataclasses.asdict(j.stack.counters)
    _close(j.pool.pool, t.pool.pool)
    assert t.ssm_state.keys() == j.ssm_state.keys()
    for k in t.ssm_state:
        _close(j.ssm_state[k], t.ssm_state[k])
    for e in engs:                       # every page but the parking page
        assert e.pool.alloc.free_pages == e.pool.alloc.total_pages - 1
        assert len(e.pool.registry) == 0
    return engs, reqs


@pytest.mark.parametrize("gens,max_batch", [
    ((5, 5, 5), 3),                      # one wave, every slot busy
    ((3, 6, 2, 4, 3), 2),                # waves; rows shift as requests end
    ((4, 1, 6), 4),                      # idle parking rows; done at prefill
])
def test_libra_engine_matches_jax(twin, gens, max_batch):
    """Prompts of 17 to 30 tokens, past the reduced window of 16; tokens,
    stats, counters, pool and the final ``ssm_state`` equal the JAX
    engine's."""
    rng = np.random.default_rng(len(gens) * 10 + max_batch)
    prompts = [rng.integers(1, 250, rng.integers(17, 31)) for _ in gens]
    _run_pair(twin, prompts, gens, max_batch=max_batch, max_len=64)


def test_decode_starts_from_the_rows_last_state(twin):
    """F1, carried: prefill writes no SSM state, so a request of the second
    wave decodes from what its row's previous owner left. Its tokens equal
    the JAX engine's, its first token (from prefill) equals the one it gets
    served alone, and its later tokens do not."""
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, 250, 20) for _ in range(4)]
    (_j, t), reqs = _run_pair(twin, prompts, (6,) * 4, max_batch=2,
                              max_len=64)
    second = [r.output for r in reqs[1][2:]]
    jm, jp, tm, tp = twin
    alone = []
    for p in prompts[2:]:
        eng = tengine.LibraEngine(tm, tp, page_size=PAGE, max_batch=2,
                                  max_len=64, parser=TParser(header_len=4),
                                  device="cpu")
        r = eng.submit(p, max_new_tokens=6)
        eng.run()
        alone.append(r.output)
    assert [o[0] for o in second] == [o[0] for o in alone]
    assert second != alone
    assert t.ssm_state["ssm"].abs().sum() > 0


def _serve_standard(twin, prompts, gen, params=None):
    jm, jp, tm, tp = twin
    engs = (jengine.StandardEngine(jm, jp, max_batch=2, max_len=48,
                                   parser=JParser(header_len=4)),
            tengine.StandardEngine(tm, tp if params is None else params,
                                   max_batch=2, max_len=48,
                                   parser=TParser(header_len=4),
                                   device="cpu"))
    reqs = [[e.submit(p, max_new_tokens=gen) for p in prompts] for e in engs]
    for e in engs:
        e.run()
    return engs, [[r.output for r in rs] for rs in reqs]


def test_baselines_serve_the_model_without_its_hybrid_parts(twin):
    """F2, carried: ``StandardEngine`` (``prefill_dense`` /
    ``decode_step_dense``) has no SSM branch and no window. Its tokens
    equal the JAX ``StandardEngine``'s and do not move when the Mamba
    parameters are perturbed, which moves ``LibraEngine``'s."""
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, 250, rng.integers(17, 25)) for _ in range(3)]
    (j, t), (j_out, t_out) = _serve_standard(twin, prompts, 4)
    assert t_out == j_out
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    _jm, _jp, tm, tp = twin
    bent = dict(tp, layers=dict(tp["layers"], ssm={
        k: v + 0.5 for k, v in tp["layers"]["ssm"].items()}))
    _engs, (_j_out, bent_out) = _serve_standard(twin, prompts, 4, bent)
    assert bent_out == t_out

    def libra(params):
        eng = tengine.LibraEngine(tm, params, page_size=PAGE, max_batch=2,
                                  max_len=48, parser=TParser(header_len=4),
                                  device="cpu")
        reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        eng.run()
        return [r.output for r in reqs]

    assert libra(bent) != libra(tp)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_serve_launcher_hybrid_reports_what_the_jax_launcher_reports():
    """``--arch hymba-1.5b`` (reduced): the boundary-traffic and payload
    lines of both launchers are identical; throughput and latency are
    timings."""
    argv = ["--arch", ARCH, "--requests", "3", "--prompt-len", "20",
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
