"""The port's kTLS-analogue bench (``benchmarks_torch/bench_ktls_analogue.py``)
and the plain versions of its kernels against the JAX package's bench
(``benchmarks/bench_ktls_analogue.py``), on the CPU.

* ``quant`` gives codes and ``amax`` bit-identical to the reference's
  ``_quant``, and ``dequant`` (``ref.ktls_dequant_ref``) values
  bit-identical to its eager ``_dequant``, at the bench's shapes with the
  context of 256 and a ragged one.
* The three regimes' plain versions (``ops.ktls_attention`` and
  ``ops.ktls_dequant`` on CPU tensors) agree within 1e-5 with the
  reference's formulas (``bench_ktls_analogue.py:41-62``, written out here:
  the closures inside its ``main`` cannot be imported), jitted as there.
* The kernels' quotient by 127 (a product with the reciprocal and one
  fma correction), emulated exactly, is the IEEE quotient over a binade.
* ``main(["--device", "cpu"])`` writes the reference's rows, once the
  wall clock's fields are dropped (``common.untimed``).
* With no card, ``main()`` raises, and the wrappers refuse CPU tensors on
  the ``'cuda'`` route.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _bench_twin
from benchmarks import bench_ktls_analogue as jbench
from benchmarks_torch import bench_ktls_analogue as tbench
from repro_torch.kernels import ops, ref

B, HQ, HKV, HD = tbench.B, tbench.HQ, tbench.HKV, tbench.HD
CONTEXTS = (256, 100)
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(ctx: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HQ, HD)).astype(np.float32)
    kv = rng.standard_normal((B, ctx, 2, HKV, HD)).astype(np.float32)
    return q, kv


def _jax_regimes():
    """The reference's three regimes, as its ``main`` defines them."""
    _dequant = jbench._dequant

    @jax.jit
    def plain(q, kv):
        k, v = kv[:, :, 0], kv[:, :, 1]
        s = jnp.einsum("bhd,bthd->bht", q, k)
        p = jax.nn.softmax(s, axis=-1)
        return jnp.einsum("bht,bthd->bhd", p, v)

    @jax.jit
    def sw_mode(q, kq, kamax):
        return plain(q, _dequant(kq, kamax))

    @jax.jit
    def hw_mode(q, kq, kamax):
        k = _dequant(kq[:, :, 0], kamax[:, :, 0])
        s = jnp.einsum("bhd,bthd->bht", q, k)
        p = jax.nn.softmax(s, axis=-1)
        v = _dequant(kq[:, :, 1], kamax[:, :, 1])
        return jnp.einsum("bht,bthd->bhd", p, v)

    return plain, sw_mode, hw_mode


@pytest.mark.parametrize("ctx", CONTEXTS)
def test_quant_and_dequant_are_bit_identical_to_the_reference(ctx):
    _q, kv = _inputs(ctx)
    jq, jamax = jbench._quant(jnp.asarray(kv))
    tq, tamax = tbench.quant(torch.from_numpy(kv))
    assert tq.dtype == torch.int8 and tamax.dtype == torch.float32
    assert tamax.shape == (B, ctx, 2, HKV, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tamax.numpy(), np.asarray(jamax))
    got = tbench.dequant(tq, tamax).numpy()
    want = np.asarray(jbench._dequant(jq, jamax))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the plain version of the kernel is the same function
    np.testing.assert_array_equal(ops.ktls_dequant(tq, tamax).numpy(), want)


@pytest.mark.parametrize("ctx", CONTEXTS)
def test_the_regimes_plain_versions_match_the_reference(ctx):
    q, kv = _inputs(ctx, seed=ctx)
    jplain, jsw, jhw = _jax_regimes()
    jq, jamax = jbench._quant(jnp.asarray(kv))
    tq_, tkv = torch.from_numpy(q), torch.from_numpy(kv)
    kq, kamax = tbench.quant(tkv)
    for name, got, want in (
            ("plain", tbench.plain(tq_, tkv), jplain(q, kv)),
            ("sw", tbench.sw_mode(tq_, kq, kamax), jsw(q, jq, jamax)),
            ("hw", tbench.hw_mode(tq_, kq, kamax), jhw(q, jq, jamax))):
        assert got.shape == (B, HQ, HD) and got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=name)
    # sw and hw compute one function: dequantise, then attend
    np.testing.assert_array_equal(tbench.sw_mode(tq_, kq, kamax).numpy(),
                                  tbench.hw_mode(tq_, kq, kamax).numpy())


def test_grouped_heads_read_their_kv_head():
    """Query head h reads KV head h // (Hq // Hkv): the plain version over 4
    KV heads equals the one over each repeated for its 3 query heads."""
    q, kv = _inputs(100)
    tq_, tkv = torch.from_numpy(q), torch.from_numpy(kv[:, :, :, :4])
    wide = tkv.repeat_interleave(HQ // 4, dim=3).contiguous()
    np.testing.assert_allclose(ref.ktls_attention_ref(tq_, tkv).numpy(),
                               ref.ktls_attention_ref(tq_, wide).numpy(),
                               **TOL)
    kq, kamax = tbench.quant(tkv)
    np.testing.assert_allclose(
        ref.ktls_attention_ref(tq_, kq, kamax).numpy(),
        ref.ktls_attention_ref(tq_, ref.ktls_dequant_ref(kq, kamax)).numpy(),
        **TOL)


def _div127_like_the_kernel(x: np.ndarray) -> np.ndarray:
    """``div127`` of ``csrc/ktls_attention.cu`` for normal float32 ``x``,
    emulated exactly: ``q = RN(x z)`` with ``z = RN(1/127)`` (the product
    is exact in float64), ``r = RN(x - 127 q)`` (exact in float64: at most
    33 significant bits), ``RN(q + r z)`` from the float64 sum and its
    TwoSum error (a float64 sum on a float32 midpoint is decided by the
    error's sign)."""
    z = np.float32(1) / np.float32(127)
    xd = x.astype(np.float64)
    q = (xd * np.float64(z)).astype(np.float32)
    r = (xd - q.astype(np.float64) * 127.0).astype(np.float32)
    p = r.astype(np.float64) * np.float64(z)
    qd = q.astype(np.float64)
    s = qd + p
    bb = s - qd
    err = (qd - (s - bb)) + (p - bb)
    f = s.astype(np.float32)
    fd = f.astype(np.float64)
    g = np.nextafter(f, np.where(s > fd, np.float32(np.inf),
                                 np.float32(-np.inf)))
    midpoint = (s != fd) & (s == (fd + g.astype(np.float64)) / 2)
    return np.where(midpoint & (err * (s - fd) > 0), g, f)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_the_kernels_quotient_by_127_is_the_ieee_quotient(sign):
    """The dequantise step of both kernels computes ``x / 127`` as ``x``
    times RN(1/127) and one fma correction. Over every float32 of [1, 2)
    it equals the IEEE quotient bit for bit (every step scales by powers of
    two, so this binade stands for every |x| >= 2^-80; the card checks all
    float32 bit patterns in ``chip_smoke.py``'s phase 22), where the
    product with the reciprocal alone differs in about 4.7 % of them."""
    x = (np.arange(1 << 23, dtype=np.uint32) | np.uint32(127 << 23)).view(
        np.float32) * np.float32(sign)
    want = (x / np.float32(127)).view(np.uint32)
    np.testing.assert_array_equal(_div127_like_the_kernel(x).view(np.uint32),
                                  want)
    recip = (x * (np.float32(1) / np.float32(127))).view(np.uint32)
    assert 0.04 < np.mean(recip != want) < 0.05


def test_main_writes_the_references_rows(tmp_path, monkeypatch):
    want = _bench_twin.jax_rows("bench_ktls_analogue", tmp_path, monkeypatch)
    got = _bench_twin.torch_rows("bench_ktls_analogue", tmp_path,
                                 monkeypatch)
    _bench_twin.assert_same_rows(got, want)
    assert [r["name"] for r in got] == [
        f"fig6c_ktls_ctx{ctx}_{mode}" for ctx in (256, 1024, 4096)
        for mode in ("plain", "sw", "hw")]
    assert got[1]["derived"].endswith("(separate pass)")
    assert got[2]["derived"].endswith("(fused inline)")


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main([])


@pytest.mark.parametrize("op", ["attention_float", "attention_int8",
                                "dequant"])
def test_the_cuda_route_refuses_cpu_tensors(op):
    q, kv = _inputs(16)
    tq_, tkv = torch.from_numpy(q), torch.from_numpy(kv)
    kq, kamax = tbench.quant(tkv)
    call = {"attention_float": lambda impl: ops.ktls_attention(
                tq_, tkv, impl=impl),
            "attention_int8": lambda impl: ops.ktls_attention(
                tq_, kq, kamax, impl=impl),
            "dequant": lambda impl: ops.ktls_dequant(kq, kamax, impl=impl),
            }[op]
    with pytest.raises(ValueError, match="CUDA tensor"):
        call("cuda")
    for impl in ("interpret", "pallas"):
        with pytest.raises(ValueError, match="TPU"):
            call(impl)
