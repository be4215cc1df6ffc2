"""The port's ``encdec`` family (whisper) against the JAX package's, on the CPU.

Weights of ``whisper-reduced`` (2 encoder and 2 decoder layers, d_model
64, 4 heads of 16, 16 frames) are made by the JAX package from a seed and
carried across with ``params_from_jax``; the same numpy-seeded frames and
prompts then go through ``repro`` and ``repro_torch`` (``attn_impl='ref'``,
the JAX side in float32 on a one-device mesh): the layer primitives
(``sinusoidal_positions`` / ``sinusoidal_rows``, ``layer_norm``),
``EncDecModel.encode`` / ``encode_anchor``, ``prefill`` and
``decode_step``. Tokens must be identical, the encoder output, pool and
``cross_kv`` within ``atol = rtol = 1e-4``. Also the faults of the
reference the port carries: the zero keys of ``blockwise_attention``'s
non-causal calls (F5), at the attention and at the model, and the decode
head's bfloat16 rounding.
"""
import dataclasses
import math
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _configs import assert_config_matches_jax

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.common.sharding import make_mesh
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.registry import build_model as j_build
from repro_torch.core.anchor_pool import AnchorPool
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import params_from_jax
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.registry import build_model as t_build

ARCH = "whisper-medium"
PAGE = 8
TOL = dict(atol=1e-4, rtol=1e-4)
#: the reference's parameter count of the published config
WHISPER_PARAMS = 758_123_520


def _close(jax_out, torch_out, tol=TOL):
    np.testing.assert_allclose(torch_out.detach().numpy(),
                               np.asarray(jax_out), **tol)


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@lru_cache(maxsize=None)
def _carry(**overrides):
    cfg = dataclasses.replace(jconfigs.get_reduced(ARCH), **overrides)
    jm = j_build(cfg, page_size=PAGE)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tconfigs.get_reduced(ARCH), **overrides)
    tm = t_build(tcfg, page_size=PAGE, attn_impl="ref")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def twin():
    """(JAX model, JAX params, port model, port params) of
    whisper-reduced, the port's weights carried across from JAX's."""
    return _carry()


def _jit_kw(b=2):
    mesh = make_mesh((1, 1), ("data", "model"))
    b_axis, combine = jattn.plan_decode_sharding(b, mesh)
    return dict(mesh=mesh, batch_axis=b_axis, combine_axes=combine,
                compute_dtype=jnp.float32)


def test_config_and_param_count_match_jax():
    for get in ("get_config", "get_reduced"):
        j, t = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        assert_config_matches_jax(j, t)
    assert tconfigs.get_config(ARCH).param_count() == \
        jconfigs.get_config(ARCH).param_count() == WHISPER_PARAMS
    tm = t_build(tconfigs.get_reduced(ARCH))
    assert isinstance(tm, EncDecModel)
    assert tm.param_count() == j_build(jconfigs.get_reduced(ARCH)).param_count()
    assert tm.cross_kv_shape(3) == (2, 3, 16, 2, 4, 16)


# ---------------------------------------------------------------------------
# layer primitives
# ---------------------------------------------------------------------------

def _frequencies(d):
    """Both packages' sinusoid frequencies, ``exp(-2i log(1e4) / d)``."""
    arg = np.arange(0, d, 2, dtype=np.float32) * np.float32(
        -math.log(10000.0) / d)
    return (np.asarray(jnp.exp(jnp.asarray(arg))),
            torch.exp(torch.from_numpy(arg)).numpy())


@pytest.mark.parametrize("length,d", [(1500, 1024), (4096, 64),
                                      (2 ** 20, 16)])
def test_sinusoidal_positions_and_rows_match_jax(length, d):
    """``sinusoidal_positions`` and ``sinusoidal_rows`` (no table) against
    the reference's table, at every row and at positions 0, 1, 1499, 4095
    and 2**20 - 1 as far as the table reaches. Where both packages' ``exp``
    give a frequency the same float32 number, the angles are the same and
    the rows agree to 1e-7. The two ``exp`` may round a frequency apart by
    its last bit, which moves position p's angle by p times that, plus the
    angle's own rounding (one float32 spacing of it): the bound allows
    exactly that there."""
    j_div, t_div = _frequencies(d)
    assert np.all(np.abs(j_div - t_div) <= np.spacing(j_div))
    d_div = np.repeat(np.abs(j_div - t_div), 2)
    angle_of = np.repeat(j_div, 2).astype(np.float64)

    def bound(p):
        ang = (p[:, None] * angle_of[None]).astype(np.float32)
        return 1e-7 + np.where(d_div > 0, p[:, None] * d_div
                               + np.spacing(ang), 0.0)

    table = np.asarray(jlayers.sinusoidal_positions(length, d))
    got = tlayers.sinusoidal_positions(length, d).numpy()
    assert got.shape == table.shape == (length, d)
    assert np.all(np.abs(got - table) <= bound(np.arange(length)))
    at = np.array([p for p in (0, 1, 1499, 4095, 2 ** 20 - 1) if p < length])
    rows = tlayers.sinusoidal_rows(torch.from_numpy(at).int(), d).numpy()
    assert np.array_equal(rows, got[at])
    assert np.all(np.abs(rows - table[at]) <= bound(at))
    shaped = tlayers.sinusoidal_rows(torch.from_numpy(at[None]), d)
    assert tuple(shaped.shape) == (1, len(at), d)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(5)
    x, w, b = _rand(rng, (3, 7, 64), 3.0), _rand(rng, (64,)), _rand(rng, (64,))
    _close(jlayers.layer_norm(x, w, b),
           tlayers.layer_norm(*map(torch.from_numpy, (x, w, b))),
           dict(atol=1e-5, rtol=1e-5))


# ---------------------------------------------------------------------------
# F5: the zero keys of the reference's blockwise branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("skv", [1040, 1500, 1536, 1024, 600])
def test_noncausal_attention_carries_the_blockwise_zero_keys(skv):
    """F5, at the attention: the reference attends with
    ``blockwise_attention`` above 1024 queries or keys, which pads K/V with
    zero keys up to a multiple of ``min(512, Skv)`` and masks them only
    when causal. The port's non-causal entry equals the branch the
    reference takes (``blockwise_attention`` above 1024, within 1e-5;
    ``dense_attention`` up to it), and at 1040 keys (496 zero keys) lies
    more than 1e-2 from ``dense_attention``."""
    rng = np.random.default_rng(skv)
    q, k, v = (_rand(rng, (1, 8, 2, 16)), _rand(rng, (1, skv, 2, 16)),
               _rand(rng, (1, skv, 2, 16)))
    pos_q = np.broadcast_to(np.arange(8), (1, 8)).astype(np.int32)
    pos_kv = np.broadcast_to(np.arange(skv), (1, skv)).astype(np.int32)
    args = tuple(map(jnp.asarray, (q, k, v, pos_q, pos_kv)))
    dense = jattn.dense_attention(*args, causal=False)
    got = tattn.noncausal_attention(*map(torch.from_numpy, (q, k, v)),
                                    impl="ref")
    assert tattn.blockwise_kv_pad(8, skv) == \
        {1040: 496, 1500: 36}.get(skv, 0)
    if skv > 1024:
        _close(jattn.blockwise_attention(*args, causal=False), got,
               dict(atol=1e-5, rtol=1e-5))
    else:
        _close(dense, got, dict(atol=1e-5, rtol=1e-5))
    gap = float(np.abs(got.numpy() - np.asarray(dense)).max())
    if skv == 1040:
        assert gap > 1e-2
    if skv in (1536, 1024, 600):
        assert gap < 1e-5


# ---------------------------------------------------------------------------
# EncDecModel
# ---------------------------------------------------------------------------

def _frames(cfg, b, seed):
    return _rand(np.random.default_rng(seed), (b, cfg.enc_frames,
                                               cfg.d_model))


def test_encode_and_encode_anchor_match_jax(twin):
    jm, jp, tm, tp = twin
    frames = _frames(tm.cfg, 2, 3)
    t_enc = tm.encode(tp, torch.from_numpy(frames))
    _close(jm.encode(jp, jnp.asarray(frames), remat="none"), t_enc)
    t_ckv = tm.encode_anchor(tp, torch.from_numpy(frames))
    assert tuple(t_ckv.shape) == tm.cross_kv_shape(2)
    _close(jm.encode_anchor(jp, jnp.asarray(frames),
                            compute_dtype=jnp.float32), t_ckv)


def _serve_pair(twin, lens, gen, steps, seed):
    """Prefill of ragged prompts after their frames in both packages, then
    ``steps`` decode steps at ``seq_lens + i``; asserts tokens equal and
    the pool and ``cross_kv`` close at every step."""
    jm, jp, tm, tp = twin
    cfg = tm.cfg
    rng = np.random.default_rng(seed)
    s = -(-max(lens) // PAGE) * PAGE
    tokens = np.stack([np.pad(rng.integers(1, cfg.vocab_size - 1, n),
                              (0, s - n)) for n in lens]).astype(np.int32)
    seq_lens = np.array(lens, np.int32)
    frames = _frames(cfg, len(lens), seed + 1)
    alloc = AnchorPool(1, 24, PAGE)
    seqs = [alloc.alloc_sequence(n + gen) for n in lens]
    tables, page_pos = alloc.tables_for(seqs, 6)
    tc = alloc.token_coords(seqs, s)
    kw = _jit_kw(len(lens))
    j_pool = jnp.zeros(jm.kv_pool_shape(alloc.total_pages), jnp.float32)
    t_pool = torch.zeros(tm.kv_pool_shape(alloc.total_pages))
    j_first, j_pool, j_ckv = jax.jit(partial(jm.prefill, **kw))(
        jp, tokens, seq_lens, j_pool, tables, *tc, frames)
    t_first, t_ckv = tm.prefill(
        tp, torch.from_numpy(tokens), torch.from_numpy(seq_lens), t_pool,
        torch.from_numpy(tables), *map(torch.from_numpy, tc),
        torch.from_numpy(frames))
    assert t_first.tolist() == np.asarray(j_first).tolist()
    _close(j_pool, t_pool)
    _close(j_ckv, t_ckv)
    j_dec = jax.jit(partial(jm.decode_step, **kw))
    cur, out = np.asarray(j_first).astype(np.int32), [t_first.tolist()]
    for i in range(steps):
        pos = (seq_lens + i).astype(np.int32)
        wsh, wsl = AnchorPool.write_coords(seqs, pos.tolist(), 1, PAGE)
        args = (cur, pos, tables, page_pos, wsh, wsl)
        j_next, j_pool = j_dec(jp, args[0], args[1], j_pool, *args[2:],
                               j_ckv)
        t_next = tm.decode_step(tp, *map(torch.from_numpy, args[:2]), t_pool,
                                *map(torch.from_numpy, args[2:]), t_ckv)
        assert t_next.tolist() == np.asarray(j_next).tolist(), i
        _close(j_pool, t_pool)
        cur = np.asarray(j_next).astype(np.int32)
        out.append(cur.tolist())
    return out


def test_prefill_and_decode_match_jax(twin):
    """Prompts of 5 and 12 tokens: first tokens, pool and ``cross_kv``,
    then four decode steps (self-attention through the pages,
    cross-attention over ``cross_kv``, the head rounded to bfloat16):
    tokens and pool."""
    out = _serve_pair(twin, [5, 12], 4, 4, 7)
    assert len(out) == 5


def test_decode_head_is_rounded_to_bfloat16(twin):
    """The JAX decode step calls ``logits`` without ``compute_dtype``, so
    its head's weights are rounded to bfloat16 (a fault of the reference,
    carried): over 20,000 random states the port's rounded head gives the
    JAX head's argmax, and the float32 head does not everywhere."""
    jm, jp, tm, tp = twin
    rng = np.random.default_rng(13)
    h = _rand(rng, (20000, tm.cfg.d_model), 3.0)
    want = np.asarray(jnp.argmax(jm.logits(jp, jnp.asarray(h)), -1))
    th = torch.from_numpy(h)
    rounded = tm.logits(tp, th, weight_dtype=torch.bfloat16).argmax(-1)
    assert np.array_equal(rounded.numpy(), want)
    assert not np.array_equal(tm.logits(tp, th).argmax(-1).numpy(), want)


def test_blockwise_branch_of_the_model_matches_jax():
    """F5, at the model: with 1040 frames (one layer of each) the
    reference's encoder and prefill cross-attention take the blockwise
    branch with 496 zero keys; the port's ``encode``, ``prefill`` and
    first decode step equal the reference's."""
    twin = _carry(enc_frames=1040, enc_layers=1, num_layers=1)
    jm, jp, tm, tp = twin
    frames = _frames(tm.cfg, 2, 21)
    _close(jm.encode(jp, jnp.asarray(frames), remat="none"),
           tm.encode(tp, torch.from_numpy(frames)))
    _serve_pair(twin, [6, 9], 2, 1, 23)


def test_model_helpers_check_their_family():
    with pytest.raises(ValueError, match="encdec"):
        EncDecModel(tconfigs.get_reduced("phi4-mini-3.8b"))
    with pytest.raises(ValueError, match="attn_impl"):
        EncDecModel(tconfigs.get_reduced(ARCH), attn_impl="pallas")
