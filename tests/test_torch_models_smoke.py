"""Twin of ``tests/test_models_smoke.py``: training's forward, loss and
gradients of every architecture, the port against the JAX package on the
CPU.

For every arch of ``ARCHS`` and ``libra-proxy-125m`` at its reduced
config, the JAX package makes the parameters from ``PRNGKey(0)`` and
``params_from_jax`` carries them across; the batch is the reference
test's (numpy seed 0, 2 x 16 tokens, bfloat16 image or frame
embeddings). Held, each with its tolerance:

- ``loss_fn`` (bfloat16, ``remat="none"``) within ``LOSS_TOL`` of the JAX
  ``loss_fn``; every gradient within ``GRAD_TOL`` of ``jax.grad``'s, by
  the relative norm of the difference, and all of them together within
  ``GRAD_GLOBAL_TOL``. The two packages round their bfloat16 products
  and sums at different places, so these bounds are wide; the float32
  twin below holds the same code paths tightly.
- ``forward(compute_dtype=float32)`` within ``1e-4`` of the JAX
  ``forward(compute_dtype=jnp.float32)``, and the gradients of a fixed
  random projection of it (plus the aux loss) within ``F32_GRAD_TOL``.
- ``remat="full"`` and ``"dots"`` equal to ``"none"`` within ``1e-3``
  (the reference's bound), gradients included.
- Across mLSTM chunks (training's cell runs chunks of 64): the cell
  ``mlstm_cell_chunked`` and its input gradients against the JAX cell's at
  ragged lengths of several chunks, and the reduced xLSTM's loss, float32
  forward and gradients at 80 positions (two chunks, the last ragged).

The JAX results come from one jitted ``value_and_grad`` an arch and a
dtype, computed once in a module-scoped fixture.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCHS, get_reduced as j_reduced
from repro.models import ssm as jssm
from repro.models.registry import build_model as j_build
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.registry import build_model as t_build

ALL = ARCHS + ["libra-proxy-125m"]
#: |port - JAX| of the bfloat16 total loss (measured up to 2.3e-3, hymba)
LOSS_TOL = 5e-3
#: relative norm of each leaf's bfloat16 gradient difference (measured up
#: to 9.1e-2 in the xLSTM, 1-2 % in the transformers). That is the scale
#: of bfloat16 itself: the JAX package's own bfloat16 gradient of
#: xlstm-reduced lies up to 12 % from its float32 one, and the port's
#: lies as close to that float32 gradient as JAX's does
GRAD_TOL = 0.15
#: the same over all leaves together (measured up to 7.5e-2, xLSTM)
GRAD_GLOBAL_TOL = 0.1
#: float32 forward (hidden states)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
#: relative norm of each leaf's float32 gradient difference (measured up
#: to 3.9e-6)
F32_GRAD_TOL = 1e-4
#: remat against none, as the reference's test holds
REMAT_TOL = 1e-3
#: (b, h, s, dh, chunk) of the mLSTM cell twin: several chunks, S ragged
CELL_CASES = [(2, 2, 100, 16, 32), (1, 3, 150, 8, 64)]
#: positions of the xLSTM twin across chunks: 64 + 16
XLSTM_LONG = 80


def _batch(cfg, b=2, s=16):
    """The reference test's ``_batch_for``: numpy seed 0, bfloat16
    embeddings."""
    rng = np.random.default_rng(0)
    batch = {
        "tokens": jnp.array(rng.integers(0, cfg.vocab_size, (b, s)),
                            jnp.int32),
        "labels": jnp.array(rng.integers(0, cfg.vocab_size, (b, s)),
                            jnp.int32),
    }
    if cfg.family == "vlm":
        batch["img_embeds"] = jnp.array(
            rng.standard_normal((b, cfg.img_tokens, cfg.d_model)),
            jnp.bfloat16)
    if cfg.family == "encdec":
        batch["frames"] = jnp.array(
            rng.standard_normal((b, cfg.enc_frames, cfg.d_model)),
            jnp.bfloat16)
    return batch


def _to_torch(batch, dtype=None):
    """The JAX batch as tensors; embeddings keep their bfloat16 values
    (widened to ``dtype`` when given)."""
    out = {}
    for k, v in batch.items():
        if v.dtype == jnp.bfloat16:
            t = torch.tensor(np.asarray(v.astype(jnp.float32)))
            out[k] = t.to(dtype or torch.bfloat16)
        else:
            out[k] = torch.tensor(np.asarray(v))
    return out


def _embeds(cfg, batch):
    """The forward's extra input of the family: image or frames."""
    if cfg.family == "vlm":
        return {"img_embeds": batch["img_embeds"]}
    if cfg.family == "encdec":
        return {"frames": batch["frames"]}
    return {}


def _projection(cfg, s=16):
    s += cfg.img_tokens if cfg.family == "vlm" else 0
    return np.random.default_rng(1).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)


def _jax_run(arch, s=16):
    cfg = j_reduced(arch)
    model = j_build(cfg, page_size=8)
    params = model.init_params(jax.random.PRNGKey(0))
    batch = _batch(cfg, s=s)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss_fn(p, batch, remat="none"), has_aux=True))(params)
    w = _projection(cfg, s)
    emb32 = {k: v.astype(jnp.float32)
             for k, v in _embeds(cfg, batch).items()}

    def f32(p):
        h, aux = model.forward(p, batch["tokens"], compute_dtype=jnp.float32,
                               remat="none", **emb32)
        return jnp.sum(h * w) + aux, h
    (_, hidden), grads32 = jax.jit(jax.value_and_grad(f32, has_aux=True))(
        params)
    np_tree = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
    return {"params": jax.tree.map(np.asarray, params), "batch": batch,
            "loss": float(loss), "nll": float(metrics["loss"]),
            "grads": np_tree(grads), "hidden": np.asarray(hidden),
            "grads32": np_tree(grads32), "w": w}


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(arch, s=16):
        if (arch, s) not in cache:
            cache[arch, s] = _jax_run(arch, s)
        return cache[arch, s]
    return get


def _port(arch, run):
    model = t_build(t_reduced(arch))
    params = params_from_jax(run["params"], model, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return model, params


def _grads(params):
    return tree_map(lambda p: (p.grad.clone() if p.grad is not None
                               else torch.zeros_like(p)), params)


def _rel_diffs(got, want) -> list:
    """``(relative norm of the difference, port leaf, JAX leaf)`` of every
    leaf."""
    out = []

    def one(g, w):
        g = g.numpy()
        out.append((np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30),
                    g, w))
    tree_map(one, got, want)
    return out


def _loss_and_grads(arch, run, remat):
    model, params = _port(arch, run)
    total, metrics = model.loss_fn(params, _to_torch(run["batch"]),
                                   remat=remat)
    total.backward()
    return (model, float(total.detach()), float(metrics["loss"].detach()),
            _grads(params))


@pytest.mark.parametrize("arch", ALL)
def test_loss_fn_matches_jax(arch, jax_runs):
    run = jax_runs(arch)
    _model, total, nll, _g = _loss_and_grads(arch, run, "none")
    assert np.isfinite(total) and total > 0
    assert abs(total - run["loss"]) < LOSS_TOL, (total, run["loss"])
    assert abs(nll - run["nll"]) < LOSS_TOL, (nll, run["nll"])


@pytest.mark.parametrize("arch", ALL)
def test_gradients_match_jax(arch, jax_runs):
    run = jax_runs(arch)
    _model, _total, _nll, grads = _loss_and_grads(arch, run, "none")
    flat = tree_leaves(grads)
    assert all(torch.isfinite(g).all() for g in flat), f"{arch}: non-finite"
    assert sum(float(g.square().sum()) for g in flat) > 0, f"{arch}: zero"
    diffs = _rel_diffs(grads, run["grads"])
    worst = max(d[0] for d in diffs)
    assert worst < GRAD_TOL, (arch, worst)
    g_all = np.concatenate([d[1].ravel() for d in diffs])
    w_all = np.concatenate([d[2].ravel() for d in diffs])
    rel = np.linalg.norm(g_all - w_all) / np.linalg.norm(w_all)
    assert rel < GRAD_GLOBAL_TOL, (arch, rel)


def _check_float32(arch, run):
    """The float32 forward and its projection's gradients against JAX's."""
    model, params = _port(arch, run)
    cfg = model.cfg
    batch = _to_torch(run["batch"], torch.float32)
    hidden, aux = model.forward(params, batch["tokens"],
                                compute_dtype=torch.float32, remat="none",
                                **_embeds(cfg, batch))
    np.testing.assert_allclose(hidden.detach().numpy(), run["hidden"],
                               **F32_TOL)
    ((hidden * torch.tensor(run["w"])).sum() + aux).backward()
    diffs = _rel_diffs(_grads(params), run["grads32"])
    worst = max(d[0] for d in diffs)
    assert worst < F32_GRAD_TOL, (arch, worst)


@pytest.mark.parametrize("arch", ALL)
def test_float32_forward_and_gradients_match_jax(arch, jax_runs):
    _check_float32(arch, jax_runs(arch))


@pytest.mark.parametrize("b,h,s,dh,chunk", CELL_CASES)
def test_mlstm_cell_chunked_gradients_match_jax(b, h, s, dh, chunk):
    """Training's mLSTM cell over several chunks, the state carried
    between them: h and the final (C, n, m) within ``F32_TOL`` of the JAX
    cell's, each input's gradient of a random projection of h within
    ``F32_GRAD_TOL`` (relative norm)."""
    rng = np.random.default_rng(s + chunk)
    q, k, v = rng.standard_normal((3, b, s, h, dh)).astype(np.float32)
    gi, gf = rng.standard_normal((2, b, s, h)).astype(np.float32)
    lf = -np.logaddexp(0.0, -gf).astype(np.float32)
    w = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    inputs = (q, k, v, gi, lf)

    def j_fn(*xs):
        hh, st = jssm.mlstm_cell_chunked(*xs, chunk=chunk)
        return jnp.sum(hh * w), (hh, st)
    (_, (jh, jst)), jg = jax.value_and_grad(
        j_fn, argnums=tuple(range(5)), has_aux=True)(
            *map(jnp.asarray, inputs))
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    th, tst = tssm.mlstm_cell_chunked(*ts, chunk=chunk)
    (th * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), **F32_TOL)
    for j, t in zip(jst, tst):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   **F32_TOL)
    for name, j, t in zip(("q", "k", "v", "log_i", "log_f"), jg, ts):
        j = np.asarray(j)
        rel = np.linalg.norm(t.grad.numpy() - j) / np.linalg.norm(j)
        assert rel < F32_GRAD_TOL, (name, rel)


def test_xlstm_across_chunks_matches_jax(jax_runs):
    """The reduced xLSTM at ``XLSTM_LONG`` positions, two chunks of its
    mLSTM blocks: the bfloat16 loss and gradients within the bars of
    ``test_loss_fn_matches_jax`` and ``test_gradients_match_jax``, the
    float32 forward and gradients within theirs."""
    arch = "xlstm-350m"
    run = jax_runs(arch, XLSTM_LONG)
    _model, total, _nll, grads = _loss_and_grads(arch, run, "none")
    assert abs(total - run["loss"]) < LOSS_TOL, (total, run["loss"])
    diffs = _rel_diffs(grads, run["grads"])
    assert max(d[0] for d in diffs) < GRAD_TOL, diffs
    _check_float32(arch, run)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ALL)
def test_remat_matches_no_remat(arch, remat, jax_runs):
    run = jax_runs(arch)
    _m, l1, _n1, g1 = _loss_and_grads(arch, run, "none")
    _m, l2, _n2, g2 = _loss_and_grads(arch, run, remat)
    assert abs(l1 - l2) < REMAT_TOL
    for a, b in zip(tree_leaves(g1), tree_leaves(g2)):
        assert float((a - b).norm()) <= REMAT_TOL * max(float(a.norm()),
                                                        1e-30)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


def test_dots_keeps_the_products_that_full_recomputes(jax_runs):
    """The backward under ``remat="full"`` reruns every forward product;
    under ``"dots"`` it reruns none of the plain ``aten.mm`` ones, and
    under ``"none"`` nothing."""
    run = jax_runs("libra-proxy-125m")
    counts = {}
    for remat in ("none", "dots", "full"):
        model, params = _port("libra-proxy-125m", run)
        total, _ = model.loss_fn(params, _to_torch(run["batch"]),
                                 remat=remat)
        with _CountMM() as mode:
            total.backward()
        counts[remat] = mode.mm
    assert counts["none"] == counts["dots"] < counts["full"], counts


def test_unknown_remat_raises(jax_runs):
    run = jax_runs("libra-proxy-125m")
    model, params = _port("libra-proxy-125m", run)
    with pytest.raises(ValueError, match="unknown remat"):
        model.loss_fn(params, _to_torch(run["batch"]), remat="some")
