"""The port's ``blockwise_attention`` (an autograd ``Function`` with a
flash-attention backward) against the JAX package's ``custom_vjp``, on
the CPU.

The same numpy-seeded q, k, v and output cotangent go through
``jax.vjp`` of ``repro.models.attention.blockwise_attention`` and through
the port's forward and ``backward``: output and ``dq``/``dk``/``dv`` must
agree within ``atol = rtol = 1e-5`` in float32 (bfloat16 within
``BF16_TOL``), over causal and windowed attention, GQA groups 1 and 4,
ragged lengths that are not multiples of the chunk, and the non-causal
call above 1024 keys that attends to the zero keys its padding adds (F5).
Where F5 does not apply it must also equal autograd through the port's
``dense_attention`` (within ``atol = rtol = 1e-5`` in float32, within
``BF16_VS_DENSE_REL`` in bfloat16: ``chip_smoke.py``'s phase 20 holds the
card to these bars at phi4-mini's head shapes). The backward keeps nothing tile-sized. Also the
forward-only guard of the CUDA kernels in ``ops``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn

TOL = dict(atol=1e-5, rtol=1e-5)
#: bfloat16 inputs: both sides round the same float32 sums to bfloat16,
#: and a sum that lands by a rounding boundary may round one bfloat16 step
#: apart (2**-7 relative at the bottom of a binade)
BF16_TOL = dict(atol=1e-3, rtol=2 ** -7)

#: bfloat16 blockwise against bfloat16 autograd through dense attention,
#: by the relative norm of the difference: the two round their products
#: to bfloat16 at different places (per tile against once), which puts
#: them 2-4e-3 apart, as far as either lies from float32 (about one
#: bfloat16 step, 3.9e-3)
BF16_VS_DENSE_REL = 1e-2

# (b, sq, skv, hq, hkv, hd, causal, window, q_chunk, kv_chunk)
CASES = {
    "causal-gqa1": (2, 24, 24, 4, 4, 16, True, 0, 8, 8),
    "causal-gqa4-window": (2, 24, 24, 8, 2, 16, True, 6, 8, 8),
    "causal-ragged": (2, 21, 21, 8, 2, 16, True, 0, 8, 8),
    "window-ragged": (1, 29, 29, 4, 1, 8, True, 10, 8, 8),
    "noncausal-ragged-gqa4": (2, 21, 13, 8, 2, 16, False, 0, 8, 8),
    "noncausal-aligned": (2, 16, 24, 4, 4, 16, False, 0, 8, 8),
    # F5: 1040 keys, one block of 512 padded with 496 zero keys
    "noncausal-f5-1040": (1, 1040, 1040, 2, 2, 16, False, 0, 512, 512),
    "cross-f5-1040": (1, 40, 1040, 4, 1, 16, False, 0, 512, 512),
}


def _inputs(b, sq, skv, hq, hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, hd)).astype(np.float32)
    do = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    pq = np.broadcast_to(np.arange(sq), (b, sq)).astype(np.int32)
    pk = np.broadcast_to(np.arange(skv), (b, skv)).astype(np.int32)
    return q, k, v, do, pq, pk


def _jax(case, dtype):
    b, sq, skv, hq, hkv, hd, causal, window, qc, kc = case
    q, k, v, do, pq, pk = _inputs(b, sq, skv, hq, hkv, hd)

    def f(q, k, v):
        return jattn.blockwise_attention(
            q, k, v, jnp.asarray(pq), jnp.asarray(pk), causal=causal,
            window=window, q_chunk=qc, kv_chunk=kc)
    out, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do, dtype))
    return [np.asarray(x, np.float32) for x in (out,) + tuple(grads)]


def _torch(fn, case, dtype):
    b, sq, skv, hq, hkv, hd, causal, window, qc, kc = case
    q, k, v, do, pq, pk = _inputs(b, sq, skv, hq, hkv, hd)
    tq, tk, tv = (torch.tensor(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    out = fn(tq, tk, tv, torch.tensor(pq), torch.tensor(pk), causal=causal,
             window=window, q_chunk=qc, kv_chunk=kc)
    out.backward(torch.tensor(do).to(dtype))
    return [x.detach().float().numpy()
            for x in (out, tq.grad, tk.grad, tv.grad)]


def _dense(q, k, v, pq, pk, *, causal, window, q_chunk, kv_chunk):
    del q_chunk, kv_chunk
    return tattn.dense_attention(q, k, v, pq, pk, causal=causal,
                                 window=window)


@pytest.mark.parametrize("name", sorted(CASES))
def test_blockwise_matches_jax_custom_vjp_float32(name):
    want = _jax(CASES[name], jnp.float32)
    got = _torch(tattn.blockwise_attention, CASES[name], torch.float32)
    for label, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=f"{name}: {label}", **TOL)


@pytest.mark.parametrize("name", ["causal-gqa4-window",
                                  "noncausal-ragged-gqa4"])
def test_blockwise_matches_jax_custom_vjp_bfloat16(name):
    want = _jax(CASES[name], jnp.bfloat16)
    got = _torch(tattn.blockwise_attention, CASES[name], torch.bfloat16)
    for label, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=f"{name}: {label}",
                                   **BF16_TOL)


@pytest.mark.parametrize("name", [n for n, c in sorted(CASES.items())
                                  if c[6] or c[2] % min(c[9], c[2]) == 0])
def test_blockwise_equals_autograd_through_dense(name):
    """Where no zero key is attended to (causal calls mask them; an
    aligned non-causal call has none), the custom backward equals
    autograd through ``dense_attention``."""
    got = _torch(tattn.blockwise_attention, CASES[name], torch.float32)
    want = _torch(_dense, CASES[name], torch.float32)
    for label, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=f"{name}: {label}", **TOL)


@pytest.mark.parametrize("name", ["causal-gqa4-window", "causal-ragged",
                                  "noncausal-aligned"])
def test_blockwise_bfloat16_near_autograd_through_dense(name):
    got = _torch(tattn.blockwise_attention, CASES[name], torch.bfloat16)
    want = _torch(_dense, CASES[name], torch.bfloat16)
    for label, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel < BF16_VS_DENSE_REL, (name, label, rel)


@pytest.mark.parametrize("name", ["noncausal-f5-1040", "cross-f5-1040"])
def test_noncausal_blockwise_attends_to_the_padded_zero_keys(name):
    """F5: above 1024 keys a non-causal call equals dense attention over
    the keys padded with ``blockwise_kv_pad`` zero rows (at position
    2**30), gradients included, and differs from dense attention over the
    real keys alone."""
    b, sq, skv, hq, hkv, hd, causal, window, qc, kc = CASES[name]
    pad = tattn.blockwise_kv_pad(sq, skv)
    assert pad == 496

    def padded_dense(q, k, v, pq, pk, **kw):
        del kw
        zeros = k.new_zeros((b, pad, hkv, hd))
        pos = torch.cat([pk, torch.full((b, pad), 2 ** 30,
                                        dtype=pk.dtype)], dim=1)
        return tattn.dense_attention(q, torch.cat([k, zeros], 1),
                                     torch.cat([v, zeros], 1), pq, pos,
                                     causal=False)
    got = _torch(tattn.blockwise_attention, CASES[name], torch.float32)
    want = _torch(padded_dense, CASES[name], torch.float32)
    for label, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=f"{name}: {label}", **TOL)
    plain = _torch(_dense, CASES[name], torch.float32)
    assert np.abs(got[0] - plain[0]).max() > 1e-2


def test_dense_or_blockwise_switches_above_1024(monkeypatch):
    rng = np.random.default_rng(3)
    seen = []
    orig = tattn.blockwise_attention

    def spy(q, *args, **kwargs):
        seen.append(q.shape[1])
        return orig(q, *args, **kwargs)
    monkeypatch.setattr(tattn, "blockwise_attention", spy)
    for s in (1024, 1025):
        q, k, v = (torch.tensor(rng.standard_normal((1, s, 2, 8)),
                                dtype=torch.float32) for _ in range(3))
        pos = torch.arange(s)[None]
        tattn.dense_or_blockwise(q, k, v, pos, pos, causal=True)
    assert seen == [1025]


def test_backward_keeps_nothing_tile_sized():
    """The forward saves q, k, v, the positions, the output and lse; the
    backward recomputes every tile."""
    b, s, h, hd = 1, 64, 2, 8
    rng = np.random.default_rng(4)
    q, k, v = (torch.tensor(rng.standard_normal((b, s, h, hd)),
                            dtype=torch.float32, requires_grad=True)
               for _ in range(3))
    pos = torch.arange(s)[None]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        out = tattn.blockwise_attention(q, k, v, pos, pos, causal=True,
                                        q_chunk=16, kv_chunk=16)
    lse = b * h * s
    assert sum(saved) <= 4 * q.numel() + 2 * s + lse
    assert max(saved) <= q.numel()
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


def _ops_call(name, requires_grad):
    g = torch.Generator().manual_seed(0)

    def t(*shape, dtype=torch.float32):
        x = torch.randn(shape, generator=g).to(dtype)
        return x.requires_grad_(requires_grad) if dtype.is_floating_point \
            else x
    if name == "flash_attention":
        return lambda: ops.flash_attention(t(1, 2, 8, 16), t(1, 2, 8, 16),
                                           t(1, 2, 8, 16), impl="cuda")
    if name == "paged_attention":
        tables = torch.zeros((1, 1), dtype=torch.int32)
        return lambda: ops.paged_attention(
            t(1, 2, 16), t(2, 4, 2, 2, 16), tables, tables.clone(),
            torch.zeros((1,), dtype=torch.int32), impl="cuda")
    return lambda: ops.mlstm_scan(t(1, 1, 16, 16), t(1, 1, 16, 16),
                                  t(1, 1, 16, 16), t(1, 1, 16), t(1, 1, 16),
                                  chunk=16, impl="cuda")


@pytest.mark.parametrize("name", ["flash_attention", "paged_attention",
                                  "mlstm_scan"])
def test_cuda_kernels_refuse_inputs_that_require_grad(name):
    """The CUDA kernels are forward only: with gradients enabled, an input
    that requires them raises before the device check; otherwise the
    device check is what refuses a CPU tensor."""
    with pytest.raises(RuntimeError, match="forward only"):
        _ops_call(name, True)()
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        _ops_call(name, False)()
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="needs a CUDA tensor"):
        _ops_call(name, True)()
