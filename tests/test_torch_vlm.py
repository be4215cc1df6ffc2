"""The port's ``vlm`` family (internvl2) against the JAX package's, on the CPU.

Weights of ``internvl2-reduced`` (2 layers, d_model 64, GQA 4/2 of 16,
8 image tokens) are made by the JAX package from a seed and carried across
with ``params_from_jax``; the same numpy-seeded patch embeddings and text
then go through ``repro`` and ``repro_torch`` (``attn_impl='ref'``, the
JAX side in float32 on a one-device mesh): ``embed`` with its image
prefix, ``TransformerLM.prefill`` with ragged text and ``decode_step`` at
the prefix-inclusive positions. Tokens must be identical, the pool within
``atol = rtol = 1e-4``. Also the contract of ``seq_lens`` (text-only at
prefill, prefix-inclusive at decode) and a fault of the reference the
port carries: the baseline ``prefill_dense`` takes no image (F4).
"""
import dataclasses
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.common.sharding import make_mesh
from repro.models import attention as jattn
from repro.models.registry import build_model as j_build
from repro_torch.core.anchor_pool import AnchorPool
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model as t_build
from repro_torch.models.transformer import TransformerLM

ARCH = "internvl2-76b"
PAGE = 8
TOL = dict(atol=1e-4, rtol=1e-4)
#: the reference's parameter count of the published config
INTERNVL2_PARAMS = 70_620_815_360


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
    tm = t_build(tconfigs.get_reduced(ARCH), page_size=PAGE, attn_impl="ref")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def twin():
    """(JAX model, JAX params, port model, port params) of
    internvl2-reduced, the port's weights carried across from JAX's."""
    return _carry()


def _jit_kw(b=2):
    mesh = make_mesh((1, 1), ("data", "model"))
    b_axis, combine = jattn.plan_decode_sharding(b, mesh)
    return dict(mesh=mesh, batch_axis=b_axis, combine_axes=combine,
                compute_dtype=jnp.float32)


def test_config_and_param_count_match_jax():
    for get in ("get_config", "get_reduced"):
        j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert tconfigs.get_config(ARCH).param_count() == \
        jconfigs.get_config(ARCH).param_count() == INTERNVL2_PARAMS
    tm = t_build(tconfigs.get_reduced(ARCH))
    assert isinstance(tm, TransformerLM)
    assert tm.param_count() == j_build(jconfigs.get_reduced(ARCH)).param_count()
    d = tm.cfg.d_model
    assert tm.template()["img_proj"].shape == (d, d)


def _image(cfg, b, seed):
    return _rand(np.random.default_rng(seed), (b, cfg.img_tokens, cfg.d_model))


def test_embed_puts_the_projected_image_first(twin):
    """``embed``: the image times ``img_proj``, then the text; without an
    image it raises (``ValueError``; the JAX package asserts), and a
    model of another family refuses one."""
    jm, jp, tm, tp = twin
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    img = _image(cfg, 2, 2)
    t_x = tm.embed(tp, torch.from_numpy(tokens), torch.from_numpy(img))
    assert tuple(t_x.shape) == (2, cfg.img_tokens + 11, cfg.d_model)
    _close(jm.embed(jp, jnp.asarray(tokens), jnp.asarray(img)), t_x)
    torch.testing.assert_close(t_x[:, cfg.img_tokens:],
                               tp["embed"][torch.from_numpy(tokens).long()])
    with pytest.raises(AssertionError):
        jm.embed(jp, jnp.asarray(tokens))
    with pytest.raises(ValueError, match="patch embeddings"):
        tm.embed(tp, torch.from_numpy(tokens))
    dense = t_build(tconfigs.get_reduced("phi4-mini-3.8b"), page_size=PAGE)
    dp = dense.init_params(0, device="cpu")
    with pytest.raises(ValueError, match="vlm"):
        dense.embed(dp, torch.from_numpy(tokens), torch.zeros(2, 8, 64))


def _setup(cfg, lens, gen, seed):
    """Ragged text prompts after an image: tokens [B, S_text], the image,
    the allocator's sequences (image + text + ``gen``) and the prefill's
    tables and token coordinates over ``img_tokens + S_text``."""
    rng = np.random.default_rng(seed)
    s = -(-max(lens) // PAGE) * PAGE
    tokens = np.stack([np.pad(rng.integers(1, cfg.vocab_size - 1, n),
                              (0, s - n)) for n in lens]).astype(np.int32)
    img = _image(cfg, len(lens), seed + 1)
    alloc = AnchorPool(1, 32, PAGE)
    seqs = [alloc.alloc_sequence(cfg.img_tokens + n + gen) for n in lens]
    tables, page_pos = alloc.tables_for(seqs, 8)
    tc = alloc.token_coords(seqs, cfg.img_tokens + s)
    return tokens, img, alloc, seqs, tables, page_pos, tc


def _prefill_pair(twin, lens, gen, seed):
    jm, jp, tm, tp = twin
    tokens, img, alloc, seqs, tables, page_pos, tc = _setup(
        tm.cfg, lens, gen, seed)
    seq_lens = np.array(lens, np.int32)
    j_pool = jnp.zeros(jm.kv_pool_shape(alloc.total_pages), jnp.float32)
    t_pool = torch.zeros(tm.kv_pool_shape(alloc.total_pages))
    j_first, j_pool = jax.jit(partial(jm.prefill, **_jit_kw(len(lens))))(
        jp, tokens, seq_lens, j_pool, tables, *tc, img_embeds=img)
    t_first = tm.prefill(tp, torch.from_numpy(tokens),
                         torch.from_numpy(seq_lens), t_pool,
                         torch.from_numpy(tables), *map(torch.from_numpy, tc),
                         img_embeds=torch.from_numpy(img))
    return (seqs, tables, page_pos, seq_lens), (j_first, j_pool), \
        (t_first, t_pool)


def _decode(model, params, first, pool, geo, steps, pos_of, jax_side):
    """``steps`` greedy decode steps from ``first``, the token of step i
    at position ``pos_of(i)``; returns the tokens of each step."""
    seqs, tables, page_pos, _lens = geo
    cur, out = np.asarray(first).astype(np.int32), []
    step_fn = jax.jit(partial(model.decode_step, **_jit_kw(len(seqs)))) \
        if jax_side else None
    for i in range(steps):
        pos = pos_of(i).astype(np.int32)
        wsh, wsl = AnchorPool.write_coords(seqs, pos.tolist(), 1, PAGE)
        args = (cur, pos, tables, page_pos, wsh, wsl)
        if jax_side:
            nxt, pool, _st = step_fn(params, args[0], args[1], pool,
                                     *args[2:])
        else:
            nxt = model.decode_step(params, *map(torch.from_numpy, args[:2]),
                                    pool, *map(torch.from_numpy, args[2:]))
        cur = np.asarray(nxt).astype(np.int32)
        out.append(cur.tolist())
    return out, pool


def test_prefill_and_decode_match_jax(twin):
    """Text of 13 and 20 tokens after an image of 8: the first tokens (at
    ``img_tokens + seq_lens - 1``) and the pool's pages equal, then four
    decode steps at ``img_tokens + seq_lens + i``: tokens and pool."""
    jm, jp, tm, tp = twin
    img_t = tm.cfg.img_tokens
    geo, (j_first, j_pool), (t_first, t_pool) = _prefill_pair(
        twin, [13, 20], 4, 7)
    assert t_first.tolist() == np.asarray(j_first).tolist()
    _close(j_pool, t_pool)
    # the image's K/V is anchored: every row's first img_tokens positions
    assert t_pool[:, :, :, 0].abs().sum() > 0
    lens = geo[3]
    pos_of = lambda i: img_t + lens + i                        # noqa: E731
    j_out, j_pool = _decode(jm, jp, j_first, j_pool, geo, 4, pos_of, True)
    t_out, _ = _decode(tm, tp, t_first, t_pool, geo, 4, pos_of, False)
    assert t_out == j_out
    _close(j_pool, t_pool)


def test_decode_seq_lens_include_the_image_prefix(twin):
    """The contract of ``seq_lens``: text-only at prefill, prefix-inclusive
    at decode. Decode steps given the text-only positions run another
    function, in both packages alike (tokens equal to each other), and
    give other tokens than the steps at the right positions."""
    jm, jp, tm, tp = twin
    img_t = tm.cfg.img_tokens
    runs = {}
    for name, shift in (("right", img_t), ("text_only", 0)):
        geo, (j_first, j_pool), (t_first, t_pool) = _prefill_pair(
            twin, [13, 20], 4, 9)
        pos_of = lambda i, _s=shift: _s + geo[3] + i           # noqa: E731
        j_out, _ = _decode(jm, jp, j_first, j_pool, geo, 4, pos_of, True)
        t_out, _ = _decode(tm, tp, t_first, t_pool, geo, 4, pos_of, False)
        assert t_out == j_out, name
        runs[name] = t_out
    assert runs["text_only"] != runs["right"]


def test_prefill_dense_takes_no_image(twin):
    """F4, carried: ``prefill_dense`` takes no image in either package, so
    under ``vlm`` the baselines serve the text-only model. The port's
    first tokens and cache equal the JAX package's, and neither moves when
    ``img_proj`` is changed, which moves ``prefill``'s."""
    jm, jp, tm, tp = twin
    cfg = tm.cfg
    rng = np.random.default_rng(11)
    tokens = rng.integers(1, cfg.vocab_size - 1, (2, 16)).astype(np.int32)
    seq_lens = np.array([12, 16], np.int32)
    j_first, j_cache = jm.prefill_dense(jp, tokens, seq_lens, 24,
                                        compute_dtype=jnp.float32)
    t_first, t_cache = tm.prefill_dense(tp, torch.from_numpy(tokens),
                                        torch.from_numpy(seq_lens), 24)
    assert t_first.tolist() == np.asarray(j_first).tolist()
    _close(j_cache, t_cache)
    bent = _rand(rng, (cfg.d_model, cfg.d_model), 3.0)
    j_bent = dict(jp, img_proj=jnp.asarray(bent))
    t_bent = dict(tp, img_proj=torch.from_numpy(bent))
    jb_first, jb_cache = jm.prefill_dense(j_bent, tokens, seq_lens, 24,
                                          compute_dtype=jnp.float32)
    tb_first, tb_cache = tm.prefill_dense(t_bent, torch.from_numpy(tokens),
                                          torch.from_numpy(seq_lens), 24)
    assert np.array_equal(np.asarray(jb_first), np.asarray(j_first))
    assert np.array_equal(np.asarray(jb_cache), np.asarray(j_cache))
    assert torch.equal(tb_first, t_first) and torch.equal(tb_cache, t_cache)

    def anchored(params):
        _tokens, img, alloc, seqs, tables, _pp, tc = _setup(cfg, [12, 16], 0,
                                                            11)
        pool = torch.zeros(tm.kv_pool_shape(alloc.total_pages))
        first = tm.prefill(params, torch.from_numpy(tokens),
                           torch.from_numpy(seq_lens), pool,
                           torch.from_numpy(tables),
                           *map(torch.from_numpy, tc),
                           img_embeds=torch.from_numpy(img))
        return first, pool

    (_f0, p0), (_f1, p1) = anchored(tp), anchored(t_bent)
    assert not torch.equal(p0, p1)
