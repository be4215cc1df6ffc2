"""The port's xLSTM slice against the JAX package's, on the CPU.

The same numpy-seeded float32 inputs go through both packages: the mLSTM
scan's plain versions (``mlstm_chunked_ref``, ``mlstm_scan_ref``) against
the JAX package's ``mlstm_cell_chunked``, ``mlstm_cell_sequential`` and the
Pallas kernel in interpret mode, at the shapes of ``tests/test_kernels.py``,
at S that is no multiple of the chunk and at gate extremes; the xLSTM
primitives and the mLSTM / sLSTM blocks; ``XLSTMModel.prefill`` and
``decode_step`` with weights carried across by ``params_from_jax``, the
JAX model run with ``compute_dtype=float32``. The scan is held to the JAX
package's bar for its Pallas kernel, ``atol = rtol = 5e-4`` (3e-3 at gate
extremes); the primitives and blocks to ``1e-5``; the model's decode state
to ``1e-4`` (several blocks of float32 rounding); token ids exactly. Also
the dispatch (no CPU fallback for the CUDA path) and that prefill goes
through the kernel's wrapper once per mLSTM block."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models.registry import build_model as j_build
from repro_torch.kernels import mlstm_scan as kmlstm
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model as t_build
from repro_torch.models.xlstm_model import XLSTMModel

SCAN_TOL = dict(atol=5e-4, rtol=5e-4)
SCAN_TOL_EXTREME = dict(atol=3e-3, rtol=3e-3)
PRIM_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "xlstm-350m"


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(jax_out, torch_out, tol):
    t = torch_out.detach().cpu().numpy()
    j = np.asarray(jax_out, np.float32)
    assert t.shape == j.shape and t.dtype == np.float32
    np.testing.assert_allclose(t, j, **tol)


def _scan_inputs(seed, b, h, s, dh, extreme=False):
    """q, k, v [B, H, S, dh]; log_i and log_f [B, H, S], drawn as
    ``tests/test_kernels.py`` draws them."""
    rng = np.random.default_rng(seed)
    q, k, v = (_rand(rng, (b, h, s, dh)) for _ in range(3))
    if extreme:
        li = (rng.standard_normal((b, h, s)) * 4).astype(np.float32)
        x = rng.standard_normal((b, h, s)) * 4
    else:
        li = _rand(rng, (b, h, s))
        x = rng.standard_normal((b, h, s)) + 2
    lf = np.log(1 / (1 + np.exp(-x))).astype(np.float32)
    return q, k, v, li, lf


def _bshd(x):
    """[B, H, S, ...] numpy -> the JAX cells' [B, S, H, ...]."""
    return jnp.asarray(np.swapaxes(x, 1, 2))


# ---------------------------------------------------------------------------
# the mLSTM scan's plain versions
# ---------------------------------------------------------------------------

SCAN_SHAPES = [(1, 1, 64, 32, 16), (2, 3, 64, 32, 32), (1, 2, 128, 64, 16)]
RAGGED = [(2, 2, 100, 16, 32), (1, 2, 70, 64, 64), (2, 1, 5, 32, 16)]


@pytest.mark.parametrize("b,h,s,dh,chunk", SCAN_SHAPES + RAGGED)
def test_mlstm_chunked_ref_matches_jax_chunked(b, h, s, dh, chunk):
    """h and the final (C, n, m) of ``mlstm_cell_chunked``, ragged S
    padded as the JAX function pads it."""
    q, k, v, li, lf = _scan_inputs(s + dh, b, h, s, dh)
    th, (tc, tn, tm) = tref.mlstm_chunked_ref(
        *map(torch.from_numpy, (q, k, v, li, lf)), chunk=chunk)
    jh, (jc, jn, jm) = jssm.mlstm_cell_chunked(
        *map(_bshd, (q, k, v, li, lf)), chunk=chunk)
    _close(np.swapaxes(np.asarray(jh), 1, 2), th, SCAN_TOL)
    for j, t in ((jc, tc), (jn, tn), (jm, tm)):
        _close(j, t, SCAN_TOL)


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("b,h,s,dh,chunk", SCAN_SHAPES + RAGGED[:1])
def test_mlstm_chunked_ref_matches_sequential_oracle(b, h, s, dh, chunk,
                                                     extreme):
    """Against the JAX sequential oracle: h and the final state."""
    q, k, v, li, lf = _scan_inputs(7 * s + dh, b, h, s, dh, extreme)
    th, (tc, tn, tm) = tref.mlstm_chunked_ref(
        *map(torch.from_numpy, (q, k, v, li, lf)), chunk=chunk)
    jh, (jc, jn, jm) = jssm.mlstm_cell_sequential(
        *map(_bshd, (q, k, v, li, lf)))
    tol = SCAN_TOL_EXTREME if extreme else SCAN_TOL
    assert torch.isfinite(th).all()
    _close(np.swapaxes(np.asarray(jh), 1, 2), th, tol)
    for j, t in ((jc, tc), (jn, tn), (jm, tm)):
        _close(j, t, tol)


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("b,h,s,dh,chunk", SCAN_SHAPES)
def test_mlstm_chunked_ref_matches_pallas_interpret(b, h, s, dh, chunk,
                                                    extreme):
    """Against the Pallas kernel in interpret mode (it returns only h)."""
    q, k, v, li, lf = _scan_inputs(3 * s + dh + chunk, b, h, s, dh, extreme)
    th = tref.mlstm_chunked_ref(*map(torch.from_numpy, (q, k, v, li, lf)),
                                chunk=chunk)[0]
    jh = jops.mlstm_scan(*map(jnp.asarray, (q, k, v, li, lf)), chunk=chunk,
                         impl="interpret")
    _close(jh, th, SCAN_TOL_EXTREME if extreme else SCAN_TOL)


@pytest.mark.parametrize("b,h,s,dh", [(1, 1, 64, 32), (2, 3, 40, 16)])
def test_mlstm_sequential_matches_jax(b, h, s, dh):
    """``mlstm_scan_ref`` and ``mlstm_cell_sequential`` (h and state)."""
    q, k, v, li, lf = _scan_inputs(11 + s, b, h, s, dh)
    t = tref.mlstm_scan_ref(*map(torch.from_numpy, (q, k, v, li, lf)))
    _close(jref.mlstm_scan_ref(*map(jnp.asarray, (q, k, v, li, lf))), t,
           PRIM_TOL)
    th, tst = tssm.mlstm_cell_sequential(
        *(torch.from_numpy(np.swapaxes(x, 1, 2)) for x in (q, k, v, li, lf)))
    jh, jst = jssm.mlstm_cell_sequential(*map(_bshd, (q, k, v, li, lf)))
    _close(jh, th, PRIM_TOL)
    for j, tt in zip(jst, tst):
        _close(j, tt, PRIM_TOL)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _torch_inputs():
    return tuple(map(torch.from_numpy, _scan_inputs(5, 1, 2, 40, 16)))


def test_mlstm_scan_auto_on_cpu_takes_the_plain_version():
    args = _torch_inputs()
    h, state = tref.mlstm_chunked_ref(*args, chunk=16)
    got = ops.mlstm_scan(*args, chunk=16)
    assert torch.equal(got, h)
    gh, gstate = ops.mlstm_scan(*args, chunk=16, impl="auto",
                                return_state=True)
    assert torch.equal(gh, h)
    assert all(torch.equal(a, b) for a, b in zip(gstate, state))
    kmlstm.reset_launches()
    ops.mlstm_scan(*args, chunk=16, impl="ref")
    assert kmlstm.LAUNCHES["mlstm_scan"] == 0


@pytest.mark.parametrize("impl", ["interpret", "pallas"])
def test_mlstm_scan_tpu_modes_raise(impl):
    with pytest.raises(ValueError, match="TPU modes"):
        ops.mlstm_scan(*_torch_inputs(), chunk=16, impl=impl)


def test_mlstm_scan_cuda_impl_on_cpu_tensors_raises():
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.mlstm_scan(*_torch_inputs(), chunk=16, impl="cuda")
    assert kmlstm.LAUNCHES["mlstm_scan"] == 0


# ---------------------------------------------------------------------------
# primitives and blocks
# ---------------------------------------------------------------------------

def test_group_norm_and_gelu_match_jax():
    rng = np.random.default_rng(21)
    x = _rand(rng, (2, 5, 24)) * 3 + 1
    w = _rand(rng, (24,))
    for groups in (1, 3, 4):
        _close(jlayers.group_norm(jnp.asarray(x), jnp.asarray(w), groups),
               tlayers.group_norm(torch.from_numpy(x), torch.from_numpy(w),
                                  groups), PRIM_TOL)
    _close(jlayers.gelu(jnp.asarray(x)), tlayers.gelu(torch.from_numpy(x)),
           PRIM_TOL)


@pytest.mark.parametrize("bias", [False, True])
def test_causal_conv1d_and_step_match_jax(bias):
    rng = np.random.default_rng(22)
    x, w, b = _rand(rng, (2, 9, 6)), _rand(rng, (4, 6)), _rand(rng, (6,))
    jb, tb = (jnp.asarray(b), torch.from_numpy(b)) if bias else (None, None)
    _close(jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jb),
           tlayers.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                 tb), PRIM_TOL)
    st = _rand(rng, (2, 3, 6))
    jo, js = jlayers.conv1d_step(jnp.asarray(x[:, 0]), jnp.asarray(st),
                                 jnp.asarray(w), jb)
    to, ts = tlayers.conv1d_step(torch.from_numpy(x[:, 0]),
                                 torch.from_numpy(st), torch.from_numpy(w), tb)
    _close(jo, to, PRIM_TOL)
    _close(js, ts, PRIM_TOL)


def _block_params(template, seed):
    """A block's parameters from the JAX package's initialiser, and the
    same numbers as torch tensors."""
    jp = jlayers.init_params(jax.random.PRNGKey(seed), template)
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


@pytest.fixture(scope="module")
def cfg():
    return tconfigs.get_reduced(ARCH)


@pytest.mark.parametrize("s", [64, 37])
def test_mlstm_block_forward_matches_jax(cfg, s):
    t = jssm.mlstm_block_template(cfg.d_model, cfg.num_heads, cfg.ssm_conv,
                                  cfg.ssm_expand)
    assert t.keys() == tssm.mlstm_block_template(
        cfg.d_model, cfg.num_heads, cfg.ssm_conv, cfg.ssm_expand).keys()
    jp, tp = _block_params(t, 1)
    x = _rand(np.random.default_rng(s), (2, s, cfg.d_model))
    jy, (jc, jn, jm) = jax.jit(partial(jssm.mlstm_block_forward, cfg=cfg,
                                       return_state=True))(jp, x)
    ty, (tc, tn, tm) = tssm.mlstm_block_forward(tp, torch.from_numpy(x), cfg,
                                                return_state=True)
    for j, tt in ((jy, ty), (jc, tc), (jn, tn), (jm, tm)):
        _close(j, tt, MODEL_TOL)
    _close(jy, tssm.mlstm_block_forward(tp, torch.from_numpy(x), cfg,
                                        impl="ref"), MODEL_TOL)


def test_mlstm_block_step_matches_jax(cfg):
    t = jssm.mlstm_block_template(cfg.d_model, cfg.num_heads, cfg.ssm_conv,
                                  cfg.ssm_expand)
    jp, tp = _block_params(t, 2)
    rng = np.random.default_rng(23)
    ud = cfg.ssm_expand * cfg.d_model
    dh = ud // cfg.num_heads
    b, h = 3, cfg.num_heads
    st = {"C": _rand(rng, (b, h, dh, dh)), "n": _rand(rng, (b, h, dh)),
          "m": _rand(rng, (b, h)), "conv": _rand(rng, (b, cfg.ssm_conv - 1,
                                                       ud))}
    x = _rand(rng, (b, cfg.d_model))
    jy, jst = jax.jit(lambda p, x, st: jssm.mlstm_block_step(p, x, cfg, st))(
        jp, x, st)
    ty, tst = tssm.mlstm_block_step(tp, torch.from_numpy(x), cfg,
                                    {k: torch.from_numpy(v)
                                     for k, v in st.items()})
    _close(jy, ty, PRIM_TOL)
    assert jst.keys() == tst.keys()
    for k in jst:
        _close(jst[k], tst[k], PRIM_TOL)


def test_slstm_block_forward_and_step_match_jax(cfg):
    t = jssm.slstm_block_template(cfg.d_model, cfg.num_heads)
    assert t.keys() == tssm.slstm_block_template(cfg.d_model,
                                                 cfg.num_heads).keys()
    jp, tp = _block_params(t, 3)
    rng = np.random.default_rng(24)
    x = _rand(rng, (2, 19, cfg.d_model))
    jy, jst = jax.jit(partial(jssm.slstm_block_forward, cfg=cfg,
                              return_state=True))(jp, x)
    ty, tst = tssm.slstm_block_forward(tp, torch.from_numpy(x), cfg,
                                       return_state=True)
    _close(jy, ty, MODEL_TOL)
    for j, tt in zip(jst, tst):
        _close(j, tt, MODEL_TOL)
    st = {k: np.array(v) for k, v in zip("cnmh", jst)}
    jy, jst = jax.jit(lambda p, x, st: jssm.slstm_block_step(p, x, cfg, st))(
        jp, x[:, 0], st)
    ty, tst = tssm.slstm_block_step(tp, torch.from_numpy(x[:, 0]), cfg,
                                    {k: torch.from_numpy(v)
                                     for k, v in st.items()})
    _close(jy, ty, MODEL_TOL)
    for k in jst:
        _close(jst[k], tst[k], MODEL_TOL)


# ---------------------------------------------------------------------------
# XLSTMModel
# ---------------------------------------------------------------------------

def _four_blocks(c):
    """[mlstm, mlstm, mlstm, slstm]: a run of more than one mLSTM block."""
    return dataclasses.replace(c, num_layers=4, slstm_every=4)


@pytest.fixture(scope="module", params=["reduced", "four-blocks"])
def twin(request):
    """(JAX model, JAX params, port model, port params); the JAX model's
    ``prefill`` and ``decode_step`` are jitted, as its serving tests run
    them."""
    jcfg, tcfg = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    if request.param == "four-blocks":
        jcfg, tcfg = _four_blocks(jcfg), _four_blocks(tcfg)
    jm = j_build(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = t_build(tcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm, device="cpu")
    jm.prefill = jax.jit(partial(jm.prefill, compute_dtype=jnp.float32))
    jm.decode_step = jax.jit(partial(jm.decode_step,
                                     compute_dtype=jnp.float32))
    return jm, jp, tm, tp


def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    s = max(lens)
    toks = rng.integers(1, cfg.vocab_size - 1, (len(lens), s)).astype(np.int32)
    for i, n in enumerate(lens):
        toks[i, n:] = 0                          # padding past seq_lens
    return toks, np.array(lens, np.int32)


def _state_close(jst, tst):
    assert jst.keys() == tst.keys()
    for k in jst:
        _close(jst[k], tst[k], MODEL_TOL)


def test_prefill_and_decode_match_jax(twin):
    """Prompts of 70, 50 and 66 tokens: first tokens and every decode-state
    tensor after prefill, then 4 greedy decode steps (tokens and state)."""
    jm, jp, tm, tp = twin
    assert tm.kinds == jm.kinds
    toks, lens = _prompts(tm.cfg, [70, 50, 66])
    jf, jst = jm.prefill(jp, toks, lens)
    tf, tst = tm.prefill(tp, torch.from_numpy(toks), torch.from_numpy(lens))
    assert tf.dtype == torch.int32
    assert tf.tolist() == np.asarray(jf).tolist()
    _state_close(jst, tst)
    jcur, tcur = jf, tf
    for step in range(4):
        pos = lens + step
        jcur, jst = jm.decode_step(jp, jcur, pos, jst)
        tcur, tst2 = tm.decode_step(tp, tcur, torch.from_numpy(pos), tst)
        assert tst2 is tst                       # updated in place
        assert tcur.tolist() == np.asarray(jcur).tolist(), step
        _state_close(jst, tst)


def test_prefill_state_is_taken_at_the_padded_end(twin):
    """A reference fault carried verbatim: the decode state (conv window
    included) is the one after the whole padded batch, not at each row's
    ``seq_lens``. Both packages agree, and the padded row's state differs
    from the state of its prompt alone."""
    jm, jp, tm, tp = twin
    toks, lens = _prompts(tm.cfg, [24, 16], seed=4)
    jf, jst = jm.prefill(jp, toks, lens)
    tf, tst = tm.prefill(tp, torch.from_numpy(toks), torch.from_numpy(lens))
    assert tf.tolist() == np.asarray(jf).tolist()
    _state_close(jst, tst)
    alone_f, alone = tm.prefill(tp, torch.from_numpy(toks[1:, :16]),
                                torch.from_numpy(lens[1:]))
    assert alone_f.tolist() == tf[1:].tolist()   # the token is read at 15
    assert not torch.allclose(alone["m_conv"], tst["m_conv"][:, 1:])
    assert not torch.allclose(alone["m_C"], tst["m_C"][:, 1:])


def test_decode_head_rounds_its_weights_like_jax():
    """The JAX model's ``decode_step`` calls ``logits`` without
    ``compute_dtype``, so its head's weights are rounded to bfloat16; the
    port's decode head does the same. Over 20,000 random hidden states of
    the reduced config the port's argmax equals the JAX head's on every
    one and its logits agree to 1e-5; the float32 head's argmax differs on
    some, so a twin of this size sees the rounding."""
    cfg = jconfigs.get_reduced(ARCH)
    jm = j_build(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = t_build(tconfigs.get_reduced(ARCH))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm, device="cpu")
    h = np.random.default_rng(19).standard_normal(
        (20_000, cfg.d_model)).astype(np.float32)
    want = np.asarray(jm.logits(jp, h[:, None]))[:, 0]
    got = tm.logits(tp, torch.from_numpy(h), weight_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), want, **PRIM_TOL)
    assert got.argmax(-1).tolist() == want.argmax(-1).tolist()
    full = tm.logits(tp, torch.from_numpy(h)).argmax(-1).numpy()
    assert (full != want.argmax(-1)).sum() > 0


def test_decode_step_uses_the_rounded_head(twin, monkeypatch):
    """``decode_step`` asks for the bfloat16 head, ``prefill`` for the
    float32 one (the JAX model passes its compute dtype there)."""
    _jm, _jp, tm, tp = twin
    asked = []
    inner = tm.logits

    def spy(params, hidden, weight_dtype=None):
        asked.append(weight_dtype)
        return inner(params, hidden, weight_dtype)
    monkeypatch.setattr(tm, "logits", spy)
    toks, lens = _prompts(tm.cfg, [9, 12], seed=5)
    first, st = tm.prefill(tp, torch.from_numpy(toks), torch.from_numpy(lens))
    tm.decode_step(tp, first, torch.from_numpy(lens), st)
    assert asked == [None, torch.bfloat16]


def test_prefill_launches_the_kernel_once_per_mlstm_block(twin, monkeypatch):
    """With ``ops.resolve`` answering 'cuda', every mLSTM block's scan goes
    through the kernel's wrapper (a fake that counts and calls the plain
    version): nothing on the prefill path goes around the kernel."""
    jm, jp, tm, tp = twin
    calls = []

    def fake(q, k, v, log_i, log_f, *, chunk=64):
        calls.append(tuple(q.shape))
        kmlstm.LAUNCHES["mlstm_scan"] += 1
        return tref.mlstm_chunked_ref(q, k, v, log_i, log_f, chunk=chunk)
    monkeypatch.setattr(kmlstm, "mlstm_scan", fake)
    resolve = ops.resolve
    monkeypatch.setattr(ops, "resolve", lambda impl, t: "cuda"
                        if impl == "auto" else resolve(impl, t))
    toks, lens = _prompts(tm.cfg, [30, 30])
    kmlstm.reset_launches()
    want = t_build(tm.cfg, mlstm_impl="ref").prefill(
        tp, torch.from_numpy(toks), torch.from_numpy(lens))
    assert calls == [] and kmlstm.LAUNCHES["mlstm_scan"] == 0
    got = tm.prefill(tp, torch.from_numpy(toks), torch.from_numpy(lens))
    ud = tm.cfg.ssm_expand * tm.cfg.d_model
    dh = ud // tm.cfg.num_heads
    assert kmlstm.LAUNCHES["mlstm_scan"] == tm.n_mlstm == len(calls)
    assert set(calls) == {(2, tm.cfg.num_heads, 30, dh)}
    assert torch.equal(got[0], want[0])
    tm.decode_step(tp, got[0], torch.from_numpy(lens), got[1])
    assert kmlstm.LAUNCHES["mlstm_scan"] == tm.n_mlstm   # decode: no scan


# ---------------------------------------------------------------------------
# configs, templates, registry
# ---------------------------------------------------------------------------

def test_config_template_and_param_count_match_jax():
    for get in ("get_config", "get_reduced"):
        j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    cfg = tconfigs.get_config(ARCH)
    jm, tm = j_build(jconfigs.get_config(ARCH)), t_build(cfg)
    assert isinstance(tm, XLSTMModel)
    assert (tm.kinds.count("mlstm"), tm.kinds.count("slstm")) == (21, 3)

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return (tuple(t.shape), tuple(t.axes), t.init, t.scale)
    assert shapes(tm.template()) == shapes(jm.template())
    assert tm.param_count() == jm.param_count() == 528_176_296
    assert cfg.param_count() == 528_176_296
    assert tm.decode_state_shapes(8) == jm.decode_state_shapes(8)
    assert tm.decode_state_shapes(8)["m_C"] == (21, 8, 4, 512, 512)


def test_init_params_and_decode_state():
    tm = t_build(tconfigs.get_reduced(ARCH))
    a, b = tm.init_params(3, device="cpu"), tm.init_params(3, device="cpu")
    c = tm.init_params(4, device="cpu")
    assert torch.equal(a["mlstm"]["wq"], b["mlstm"]["wq"])
    assert not torch.equal(a["mlstm"]["wq"], c["mlstm"]["wq"])
    assert torch.count_nonzero(a["mlstm"]["ln_w"]) == 0
    assert torch.equal(a["slstm"]["gn_w"], torch.ones_like(a["slstm"]["gn_w"]))
    st = tm.init_decode_state(2, device="cpu")
    assert (st["m_m"] == -1e30).all() and (st["s_m"] == -1e30).all()
    assert all(not v.any() for k, v in st.items() if k not in ("m_m", "s_m"))
    with pytest.raises(ValueError, match="mlstm_impl"):
        XLSTMModel(tm.cfg, mlstm_impl="interpret")


def test_serve_launcher_refuses_the_ssm_family():
    """``LibraEngine`` has no KV pool for xLSTM (neither has the JAX
    engine): the launcher does not offer it."""
    with pytest.raises(SystemExit):
        tserve.main(["--arch", ARCH, "--device", "cpu"])
