"""The port's MoE block against the JAX package's, on the CPU.

Parameters are made by the JAX package from a seed (``init_params`` of
``moe_template``) and carried across as float32; the same numpy-seeded
inputs go through ``repro.models.moe`` and ``repro_torch.models.moe`` for
the reduced qwen2-moe (6 experts padded to 8, 2 shared, top-2) and the
reduced qwen3-moe (8 experts, top-2, no shared). ``router_topk``'s gates
must agree to 1e-6 and its expert ids exactly; ``_dispatch_compute_combine``,
``_shared_expert``, ``moe_ffn`` and ``aux_load_balance_loss`` to
``atol = rtol = 1e-5`` (float32 products summed in another order), at
capacity factors 1.25 (training's) and 2.0 (serving's). Which entries a
capacity limit keeps is compared exactly with the reference's rule
(l.79-86 of ``repro/models/moe.py``, transcribed in numpy), on inputs
where some are dropped, and a plain loop over the kept entries computes
what both packages must return. Also ``params_from_jax`` on a MoE tree."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models.registry import build_model as j_build
from repro_torch.common.types import ModelConfig
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model as t_build

TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"]
FACTORS = [1.25, 2.0]
# rows: a decode batch, a short prompt and a prefill wave in which the
# skewed inputs overflow some experts' capacity at both factors
ROWS = [4, 37, 192]


@pytest.fixture(scope="module", params=ARCHS)
def block(request):
    """(arch, config, JAX params, port params) of the reduced config's MoE
    block. The config is the port's: both packages' functions read it (its
    JAX fields equal the reference's, ``test_torch_serving``), and the
    port's router reads ``norm_topk`` too."""
    cfg = tconfigs.get_reduced(request.param)
    jp = jlayers.init_params(jax.random.PRNGKey(1), jmoe.moe_template(cfg))
    tp = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in jax.tree.map(np.asarray, jp).items()}
    return request.param, cfg, jp, tp


def _inputs(cfg, t, seed=0):
    """x [t, D]: N(0, 1) rows plus a common direction, so that the router
    favours some experts and a capacity limit bites."""
    rng = np.random.default_rng(seed + t)
    u = rng.standard_normal(cfg.d_model).astype(np.float32)
    return (rng.standard_normal((t, cfg.d_model)).astype(np.float32)
            + 1.5 * u)


def _close(jax_out, torch_out, tol=TOL):
    t = torch_out.detach().numpy()
    j = np.asarray(jax_out, np.float32)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, **tol)


def _routed(cfg, jp, x):
    """The reference's router on x: (logits, gates, ids) as numpy."""
    logits = jnp.asarray(x) @ jp["router"]
    gates, ids = jmoe.router_topk(logits, cfg)
    return np.array(logits), np.array(gates), np.array(ids)


def _reference_kept(ids, cfg, cap):
    """The reference's kept-entry rule (repro/models/moe.py l.79-86) in
    numpy on one device: kept[token, choice]."""
    t, k = ids.shape
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    se = flat[order]
    first = np.searchsorted(se, np.arange(cfg.padded_experts), side="left")
    pos = np.arange(t * k) - first[se]
    kept = np.zeros(t * k, bool)
    kept[order] = pos < cap
    return kept.reshape(t, k)


def _loop_moe(x, p, gates, ids, kept):
    """Plain loop over the kept entries: sum of gate * SwiGLU_expert(x)."""
    silu = lambda a: a / (1.0 + np.exp(-a))
    out = np.zeros_like(x, np.float64)
    for i in range(x.shape[0]):
        for j in range(ids.shape[1]):
            if kept[i, j]:
                e = ids[i, j]
                h = silu(x[i] @ p["w_gate"][e]) * (x[i] @ p["w_up"][e])
                out[i] += gates[i, j] * (h @ p["w_down"][e])
    return out


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", ROWS)
def test_router_topk_matches_jax(block, t):
    _arch, cfg, jp, tp = block
    logits = _inputs(cfg, t) @ np.asarray(jp["router"])
    jg, ji = jmoe.router_topk(jnp.asarray(logits), cfg)
    tg, ti = tmoe.router_topk(torch.from_numpy(logits), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(jg, tg, dict(atol=1e-6, rtol=1e-6))
    assert (ti < cfg.num_experts).all()        # padded experts never chosen
    np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("t", ROWS)
def test_aux_load_balance_loss_matches_jax(block, t):
    _arch, cfg, jp, _tp = block
    logits, _g, ids = _routed(cfg, jp, _inputs(cfg, t))
    want = jmoe.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(ids),
                                      cfg)
    got = tmoe.aux_load_balance_loss(torch.from_numpy(logits),
                                     torch.from_numpy(ids), cfg)
    _close(want, got)


# ---------------------------------------------------------------------------
# dispatch, experts, combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("t", ROWS)
def test_dispatch_compute_combine_matches_jax(block, t, factor):
    """Same routing in, same combined output out; the kept entries are the
    reference's, and a loop over them gives the output of both."""
    _arch, cfg, jp, tp = block
    x = _inputs(cfg, t)
    _logits, gates, ids = _routed(cfg, jp, x)
    e = cfg.padded_experts
    want = jmoe._dispatch_compute_combine(
        jnp.asarray(x), jp["w_gate"], jp["w_up"], jp["w_down"],
        jnp.asarray(gates), jnp.asarray(ids), cfg, factor, 0, e)
    tx, tg, ti = map(torch.from_numpy, (x, gates, ids))
    got = tmoe._dispatch_compute_combine(tx, tp["w_gate"], tp["w_up"],
                                         tp["w_down"], tg, ti, cfg, factor,
                                         0, e)
    _close(want, got)

    cap = tmoe.expert_capacity(t, cfg, factor)
    assert cap == min(max(8, math.ceil(t * cfg.top_k / e * factor)), t)
    plan = tmoe.dispatch_plan(ti, cfg, cap, 0, e)
    kept = np.zeros(t * cfg.top_k, bool)
    kept[plan.order.numpy()] = plan.kept.numpy()
    ref_kept = _reference_kept(ids, cfg, cap)
    np.testing.assert_array_equal(kept.reshape(t, -1), ref_kept)
    loop = _loop_moe(x, {k: np.asarray(v) for k, v in jp.items()}, gates,
                     ids, ref_kept)
    np.testing.assert_allclose(np.asarray(want), loop, **TOL)
    np.testing.assert_allclose(got.numpy(), loop, **TOL)


@pytest.mark.parametrize("factor", FACTORS)
def test_capacity_drops_the_reference_entries(block, factor):
    """At 192 skewed rows some entries overflow their expert at both
    factors: the same ones in both packages, their tokens' rows left
    without those experts' parts."""
    _arch, cfg, jp, _tp = block
    t = ROWS[-1]
    _logits, _gates, ids = _routed(cfg, jp, _inputs(cfg, t))
    cap = tmoe.expert_capacity(t, cfg, factor)
    plan = tmoe.dispatch_plan(torch.from_numpy(ids), cfg, cap, 0,
                              cfg.padded_experts)
    dropped = int((~plan.kept).sum())
    assert dropped > 0
    assert dropped == int((~_reference_kept(ids, cfg, cap)).sum())
    counts = np.bincount(ids.reshape(-1), minlength=cfg.padded_experts)
    assert dropped == int(np.maximum(counts - cap, 0).sum())
    # every dropped entry points at the one row past the buffer
    assert (plan.dst[~plan.kept] == cfg.padded_experts * cap).all()


def test_dispatch_plan_of_an_expert_range(block):
    """The expert range the reference's expert-parallel path gives each
    device: entries outside it are not kept, inside it they keep their
    global order, at local rows."""
    _arch, cfg, jp, _tp = block
    t, cap = 37, 16
    _l, _g, ids = _routed(cfg, jp, _inputs(cfg, t))
    ti = torch.from_numpy(ids)
    full = tmoe.dispatch_plan(ti, cfg, cap, 0, cfg.padded_experts)
    half = cfg.padded_experts // 2
    hi = tmoe.dispatch_plan(ti, cfg, cap, half, half)
    se = ti.reshape(-1)[full.order]
    assert torch.equal(hi.kept, full.kept & (se >= half))
    assert torch.equal(hi.dst[hi.kept], full.dst[hi.kept] - half * cap)


@pytest.mark.parametrize("t", ROWS)
def test_shared_expert_matches_jax(block, t):
    _arch, cfg, jp, tp = block
    if not cfg.num_shared_experts:
        assert "shared_gate" not in tp
        return
    x = _inputs(cfg, t)
    _close(jmoe._shared_expert(jp, jnp.asarray(x)),
           tmoe._shared_expert(tp, torch.from_numpy(x)))


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("t", ROWS)
def test_moe_ffn_matches_jax(block, t, factor):
    _arch, cfg, jp, tp = block
    x = _inputs(cfg, t, seed=3)
    jo, ja = jmoe.moe_ffn(jp, jnp.asarray(x), cfg, capacity_factor=factor,
                          return_aux=True)
    to, ta = tmoe.moe_ffn(tp, torch.from_numpy(x), cfg,
                          capacity_factor=factor, return_aux=True)
    _close(jo, to)
    _close(ja, ta)
    plain = tmoe.moe_ffn(tp, torch.from_numpy(x), cfg,
                         capacity_factor=factor)
    assert torch.equal(plain, to)


def test_moe_template_matches_jax(block):
    _arch, cfg, _jp, _tp = block
    j = jmoe.moe_template(cfg)
    t = tmoe.moe_template(cfg)
    assert sorted(j) == sorted(t)
    for k in j:
        assert (j[k].shape, j[k].axes, j[k].init) == \
            (t[k].shape, t[k].axes, t[k].init)
    assert t["w_gate"].shape[0] == cfg.padded_experts


# ---------------------------------------------------------------------------
# params_from_jax on a MoE tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_the_moe_subtree(arch):
    cfg = jconfigs.get_reduced(arch)
    jp = j_build(cfg, page_size=8).init_params(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tm = t_build(tconfigs.get_reduced(arch), page_size=8)
    tp = params_from_jax(tree, tm, device="cpu")
    moe = tp["layers"]["moe"]
    want = {"router", "w_gate", "w_up", "w_down"}
    if cfg.num_shared_experts:
        want |= {"shared_gate", "shared_up", "shared_down",
                 "shared_gate_proj"}
    assert set(moe) == want and "mlp" not in tp["layers"]
    e, d, f = cfg.padded_experts, cfg.d_model, cfg.expert_d_ff
    assert tuple(moe["w_gate"].shape) == (cfg.num_layers, e, d, f)
    assert tuple(moe["w_down"].shape) == (cfg.num_layers, e, f, d)
    assert tuple(moe["router"].shape) == (cfg.num_layers, d, e)
    for k in want:
        np.testing.assert_array_equal(moe[k].numpy(),
                                      tree["layers"]["moe"][k])


def test_params_from_jax_refuses_a_wrong_expert_count():
    """A tree made without the padding (6 experts, not 8) does not fit the
    reduced qwen2-moe's template; nor does one without shared experts."""
    cfg = jconfigs.get_reduced("qwen2-moe-a2.7b")
    tm = t_build(tconfigs.get_reduced("qwen2-moe-a2.7b"), page_size=8)
    unpadded = cfg.__class__(**{**cfg.__dict__, "expert_pad_to": 0})
    assert unpadded.padded_experts == 6
    tree = jax.tree.map(np.asarray, j_build(unpadded, page_size=8)
                        .init_params(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, tm, device="cpu")
    no_shared = cfg.__class__(**{**cfg.__dict__, "num_shared_experts": 0})
    tree = jax.tree.map(np.asarray, j_build(no_shared, page_size=8)
                        .init_params(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(tree, tm, device="cpu")


def test_padded_experts_are_never_routed():
    """Padded experts masked to -1e30 before the softmax: even logits that
    favour them most leave them unchosen."""
    cfg = ModelConfig(name="pad", family="moe", num_layers=1, d_model=8,
                      num_heads=2, num_kv_heads=2, d_ff=0, vocab_size=16,
                      expert_d_ff=4, num_experts=3, expert_pad_to=8, top_k=2)
    logits = torch.zeros(5, 8)
    logits[:, 3:] = 50.0
    gates, ids = tmoe.router_topk(logits, cfg)
    assert (ids < 3).all()
    np.testing.assert_allclose(gates.numpy(), 0.5, rtol=1e-6)
