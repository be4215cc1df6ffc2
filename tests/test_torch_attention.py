"""The port's attention against the JAX package's, on the CPU.

The same numpy-seeded float32 inputs go through the JAX package and the
port: the plain versions of the two attention kernels
(``flash_attention_ref``, ``paged_attention_ref``) against the Pallas
kernels in interpret mode and against the jnp oracles, at the shapes of
``tests/test_kernels.py`` plus a tail ``Sq``, an all-masked page, ``-1``
slots and windows; the model primitives (``rms_norm``, ``apply_rope``,
``mlp_apply``) and attention paths (``dense_attention``,
``paged_decode_attention``, ``prefill_write_pages``) against their JAX
twins. Float results must agree to ``atol = rtol = 1e-4`` (the bar of
``tests/test_kernels.py`` for float32 paged attention), integer results
exactly. Also pins the dispatch: no CPU fallback for the CUDA path."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.sharding import make_mesh
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(jax_out, torch_out):
    t = torch_out.detach().cpu().numpy()
    j = np.asarray(jax_out, np.float32)
    assert t.shape == j.shape and t.dtype == np.float32
    np.testing.assert_allclose(t, j, **TOL)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_SHAPES = [(1, 1, 1, 128, 64, 64), (2, 4, 2, 256, 64, 128),
                (1, 8, 8, 128, 128, 64), (2, 6, 2, 128, 32, 64)]


def _qkv(seed, b, hq, hkv, sq, hd, skv=None):
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    return (_rand(rng, (b, hq, sq, hd)), _rand(rng, (b, hkv, skv, hd)),
            _rand(rng, (b, hkv, skv, hd)))


def _flash_twin(q, k, v, *, causal, window, block=None):
    t = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, window=window)
    _close(jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                    causal=causal, window=window), t)
    if block is not None:
        _close(jops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                    causal=causal, window=window,
                                    impl="interpret", block_q=block,
                                    block_k=block), t)
    return t


@pytest.mark.parametrize("b,hq,hkv,s,hd,blk", FLASH_SHAPES)
def test_flash_ref_matches_jax(b, hq, hkv, s, hd, blk):
    _flash_twin(*_qkv(s + hd, b, hq, hkv, s, hd), causal=True, window=0,
                block=blk)


@pytest.mark.parametrize("window", [16, 64, 100])
def test_flash_ref_window_matches_jax(window):
    _flash_twin(*_qkv(window, 1, 2, 2, 256, 32), causal=True, window=window,
                block=64)


def test_flash_ref_noncausal_matches_jax():
    _flash_twin(*_qkv(3, 2, 2, 2, 128, 32), causal=False, window=0, block=64)


@pytest.mark.parametrize("sq,skv,window", [(40, 40, 0), (72, 72, 24),
                                           (16, 40, 0), (33, 33, 0)])
def test_flash_ref_tail_lengths_match_jax(sq, skv, window):
    """Lengths that are no multiple of a tile (the Pallas kernel refuses
    them, the CUDA kernel masks them): held against the jnp oracle."""
    _flash_twin(*_qkv(sq, 2, 6, 2, sq, 16, skv), causal=True, window=window)


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

def _paged_case(seed, b, hq, hkv, hd, page, pps, p_total, seq_lens):
    """The layout of tests/test_kernels.py's ``_paged_setup``."""
    rng = np.random.default_rng(seed)
    q = _rand(rng, (b, hq, hd))
    pool = _rand(rng, (p_total, page, 2, hkv, hd))
    tables = np.full((b, pps), -1, np.int32)
    page_pos = np.full((b, pps), -(2 ** 20), np.int32)
    ctr = 0
    for i in range(b):
        for j in range(seq_lens[i] // page + 1):
            tables[i, j] = ctr % p_total
            page_pos[i, j] = j * page
            ctr += 1
    return q, pool, tables, page_pos, np.asarray(seq_lens, np.int32)


def _paged_twin(case, *, window=0, interpret=True):
    t = tref.paged_attention_ref(*map(torch.from_numpy, case), window=window)
    j_args = tuple(map(jnp.asarray, case))
    for want in [jref.paged_attention_ref(*j_args, window=window)] + (
            [jops.paged_attention(*j_args, window=window, impl="interpret")]
            if interpret else []):
        for a, b in zip(want, t):
            _close(a, b)
    return t


@pytest.mark.parametrize("b,hq,hkv,hd,page", [
    (2, 4, 2, 64, 16), (3, 8, 8, 32, 8), (1, 6, 1, 128, 32),
])
def test_paged_ref_matches_jax(b, hq, hkv, hd, page):
    seq = np.random.default_rng(page).integers(1, page * 3, b)
    _paged_twin(_paged_case(hd, b, hq, hkv, hd, page, 4, 24, seq))


@pytest.mark.parametrize("window", [5, 12])
def test_paged_ref_window_matches_jax(window):
    _paged_twin(_paged_case(1, 2, 6, 2, 16, 8, 4, 12, [20, 9]),
                window=window)


def test_paged_ref_masked_pages_and_gaps_match_jax():
    """A ``-1`` slot between valid ones, a page wholly past ``seq_len``
    (every key masked while ``m`` is still -1e30), and a row with nothing
    valid but its first key (an idle engine slot on its parking page)."""
    q, pool, tables, page_pos, seq = _paged_case(2, 3, 4, 2, 16, 8, 5, 16,
                                                 [17, 30, 0])
    tables[0, 1], tables[0, 3] = -1, 7          # gap; then a page past 17
    page_pos[0, 3] = 40
    tables[1, 0] = -1                           # leading gap
    case = (q, pool, tables, page_pos, seq)
    acc, m, l = _paged_twin(case)
    assert torch.isfinite(acc).all() and (l > 0).all()


def test_paged_ref_equals_dense_attention():
    """Combined partials equal full attention over the logical KV."""
    b, hq, hkv, hd, page = 2, 4, 2, 32, 8
    seq = np.array([20, 13])
    q, pool, tables, page_pos, sl = _paged_case(4, b, hq, hkv, hd, page, 6,
                                                32, seq)
    acc, _m, l = tref.paged_attention_ref(
        *map(torch.from_numpy, (q, pool, tables, page_pos, sl)))
    out = acc / l.clamp(min=1e-30)[..., None]
    for i in range(b):
        ln = int(seq[i]) + 1
        kv = torch.from_numpy(pool[tables[i, :ln // page + 1]]).reshape(
            -1, 2, hkv, hd)[:ln]
        pos = torch.arange(ln)[None]
        want = tattn.dense_attention(
            torch.from_numpy(q[i])[None, None], kv[None, :, 0],
            kv[None, :, 1], torch.tensor([[int(seq[i])]]), pos)
        torch.testing.assert_close(out[i], want[0, 0], **TOL)


# ---------------------------------------------------------------------------
# model primitives and attention paths
# ---------------------------------------------------------------------------

def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, (3, 5, 64)), _rand(rng, (64,))
    _close(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5),
           tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5))
    zeros = torch.zeros(64)                       # (1 + w) scaling
    out = tlayers.rms_norm(torch.from_numpy(x), zeros)
    torch.testing.assert_close(out.square().mean(-1),
                               torch.ones(3, 5), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 7, 3, 16))
    pos = rng.integers(0, 1100, (2, 7)).astype(np.int32)
    _close(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              theta))


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_apply_matches_jax(act):
    rng = np.random.default_rng(2)
    tmpl = jlayers.mlp_template(32, 48, act)
    p = {k: _rand(rng, s.shape) for k, s in tmpl.items()}
    x = _rand(rng, (4, 32))
    _close(jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), act),
           tlayers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), act))
    assert set(tlayers.mlp_template(32, 48, act)) == set(tmpl)


@pytest.mark.parametrize("causal,window,valid", [(True, 0, False),
                                                 (True, 6, False),
                                                 (False, 0, True)])
def test_dense_attention_matches_jax(causal, window, valid):
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, (2, 9, 6, 16)), _rand(rng, (2, 9, 2, 16)), \
        _rand(rng, (2, 9, 2, 16))
    pos = np.broadcast_to(np.arange(9), (2, 9)).astype(np.int32)
    kv_valid = (np.arange(9)[None] < np.array([[5], [9]])) if valid else None
    _close(jattn.dense_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                 causal=causal, window=window,
                                 kv_valid=None if kv_valid is None
                                 else jnp.asarray(kv_valid)),
           tattn.dense_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                                 causal=causal, window=window,
                                 kv_valid=None if kv_valid is None
                                 else torch.from_numpy(kv_valid)))


@pytest.mark.parametrize("s", [16, 21])
def test_prefill_attention_matches_jax_dense_attention(s):
    """The prefill path (``ops.flash_attention`` on the transposed layout,
    its plain version on the CPU) computes what the JAX model's
    ``dense_attention`` computes at positions ``arange(S)``."""
    rng = np.random.default_rng(s)
    q, k, v = _rand(rng, (2, s, 4, 16)), _rand(rng, (2, s, 2, 16)), \
        _rand(rng, (2, s, 2, 16))
    pos = np.broadcast_to(np.arange(s), (2, s)).astype(np.int32)
    _close(jattn.dense_attention(*map(jnp.asarray, (q, k, v, pos, pos))),
           tattn.prefill_attention(*map(torch.from_numpy, (q, k, v))))


def _mesh_kw(b):
    mesh = make_mesh((1, 1), ("data", "model"))
    b_axis, combine = jattn.plan_decode_sharding(b, mesh)
    return dict(mesh=mesh, batch_axis=b_axis, combine_axes=combine)


def test_paged_decode_attention_matches_jax():
    """Write the new token's K/V (one row's write page is missing, so its
    write is dropped) and attend; output and pool must agree."""
    rng = np.random.default_rng(4)
    b, hq, hkv, hd, page, pps, p_total = 3, 4, 2, 16, 8, 4, 14
    q = _rand(rng, (b, hq, hd))
    k_new, v_new = _rand(rng, (b, hkv, hd)), _rand(rng, (b, hkv, hd))
    pool = _rand(rng, (p_total, page, 2, hkv, hd))
    seq = np.array([11, 0, 20], np.int32)
    tables = np.array([[[3, 5, -1, -1]], [[9, -1, -1, -1]],
                       [[0, 1, -1, -1]]], np.int32)
    page_pos = np.array([[[0, 8, -1, -1]], [[0, -1, -1, -1]],
                         [[0, 8, -1, -1]]], np.int32)
    wsh = np.zeros(b, np.int32)
    wsl = np.array([1, 0, 2], np.int32)        # row 2's slot 2 is -1: dropped
    args = (q, k_new, v_new, pool, tables, page_pos, seq, wsh, wsl)
    j_out, j_pool = jattn.paged_decode_attention(*map(jnp.asarray, args),
                                                 **_mesh_kw(b))
    t_args = list(map(torch.from_numpy, args))
    t_out = tattn.paged_decode_attention(*t_args)
    _close(j_out, t_out)
    _close(j_pool, t_args[3])                  # the pool, updated in place
    # row 2 is dropped: it writes row 0's value into row 0's slot again
    src, pid, off, kept = tattn.decode_write_index(*t_args[4:], page)
    assert src.tolist() == [0, 1, 0] and pid.tolist() == [5, 9, 5] \
        and off.tolist() == [3, 0, 3] and bool(kept)


def test_prefill_write_pages_matches_jax():
    rng = np.random.default_rng(5)
    b, s, hkv, hd, page, p_total = 2, 16, 2, 8, 8, 6
    k, v = _rand(rng, (b, s, hkv, hd)), _rand(rng, (b, s, hkv, hd))
    pool = _rand(rng, (p_total, page, 2, hkv, hd))
    tables = np.array([[[2, 4]], [[1, -1]]], np.int32)
    tsh = np.zeros((b, s), np.int32)
    tsl = np.repeat((np.arange(s) // page)[None], b, 0).astype(np.int32)
    toff = np.repeat((np.arange(s) % page)[None], b, 0).astype(np.int32)
    tval = np.arange(s)[None] < np.array([[13], [16]])
    args = (k, v, pool, tables, tsh, tsl, toff, tval)
    mk = _mesh_kw(b)
    j_pool = jattn.prefill_write_pages(*map(jnp.asarray, args), **mk)
    t_args = list(map(torch.from_numpy, args))
    out = tattn.prefill_write_pages(*t_args)
    assert out is t_args[2]
    _close(j_pool, out)


@pytest.mark.parametrize("path", ["decode", "prefill"])
def test_writes_that_keep_no_row_leave_the_pool_unchanged(path):
    """Every row dropped (its page on the other shard, or missing): the
    static write puts each slot's own value back, so the pool stays bit
    for bit what it was, as the JAX package's ``mode="drop"`` leaves it."""
    rng = np.random.default_rng(7)
    b, s, hkv, hd, page, p_total = 2, 8, 2, 8, 8, 6
    pool = _rand(rng, (p_total, page, 2, hkv, hd))
    tables = np.array([[[2, -1], [3, 4]], [[-1, -1], [1, 5]]], np.int32)
    if path == "decode":
        page_pos = np.array([[[0, -1], [0, 8]], [[-1, -1], [0, 8]]],
                            np.int32)
        args = (_rand(rng, (b, 4, hd)), _rand(rng, (b, hkv, hd)),
                _rand(rng, (b, hkv, hd)), pool, tables, page_pos,
                np.array([3, 9], np.int32), np.array([1, 0], np.int32),
                np.array([0, 0], np.int32))
        j_out, j_pool = jattn.paged_decode_attention(
            *map(jnp.asarray, args), **_mesh_kw(b))
        t_args = list(map(torch.from_numpy, args))
        _close(j_out, tattn.paged_decode_attention(*t_args))
        t_pool = t_args[3]
    else:
        tsh = np.array([[1] * s, [0] * s], np.int32)
        zeros = np.zeros((b, s), np.int32)
        tval = np.array([[False] * s, [True] * s])
        args = (_rand(rng, (b, s, hkv, hd)), _rand(rng, (b, s, hkv, hd)),
                pool, tables, tsh, zeros, zeros, tval)
        j_pool = jattn.prefill_write_pages(*map(jnp.asarray, args),
                                           **_mesh_kw(b))
        t_args = list(map(torch.from_numpy, args))
        t_pool = tattn.prefill_write_pages(*t_args)
    np.testing.assert_array_equal(np.asarray(j_pool), pool)
    np.testing.assert_array_equal(t_pool.numpy(), pool)


# ---------------------------------------------------------------------------
# dispatch: the plain version only for CPU tensors, never a silent fallback
# ---------------------------------------------------------------------------

def _attn_calls():
    q, k, v = map(torch.from_numpy, _qkv(0, 1, 2, 1, 8, 16))
    pcase = tuple(map(torch.from_numpy,
                      _paged_case(0, 2, 4, 2, 16, 8, 3, 6, [9, 4])))
    return {
        "flash_attention": lambda impl: ops.flash_attention(q, k, v,
                                                            impl=impl),
        "paged_attention": lambda impl: ops.paged_attention(*pcase,
                                                            impl=impl),
    }


@pytest.mark.parametrize("op", ["flash_attention", "paged_attention"])
def test_attention_cuda_impl_on_cpu_tensors_raises(op):
    call = _attn_calls()[op]
    with pytest.raises(ValueError, match="CUDA tensor"):
        call("cuda")
    for impl in ("interpret", "pallas"):
        with pytest.raises(ValueError, match="TPU"):
            call(impl)


@pytest.mark.parametrize("op", ["flash_attention", "paged_attention"])
def test_attention_auto_on_cpu_takes_the_plain_version(op):
    kattn.reset_launches()
    call = _attn_calls()[op]
    got, want = call("auto"), call("ref")
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)
    assert all(n == 0 for n in kattn.LAUNCHES.values())

