"""Twins of ``tests/test_crypto_datapath.py``: the kTLS-analogue datapath.

Every test of the JAX package's file (every parametrised case) runs
through ``repro.core`` and through the port's ``repro_torch.core``
(``device="cpu"``) on the same seeds (``tests/_twin.py``): its own
assertions hold on both sides, and wire bytes, ``CopyCounters``, page
counts, ``xfer`` counts and ``fused_buffers`` are identical.

Impls. ``test_recv_batch_kernel_impl_decrypts_like_host[interpret]`` fails
on the installed jax (``pl.load``) and names a TPU mode the port does not
have: both sides run it as ``'ref'``. The test also runs the port's
``'auto'`` and ``'fused-round'`` (the JAX side ``'auto'`` and
``'fused-round:ref'``), which take the plain versions on CPU tensors.

``test_kernel_keystream_operand_bit_exact_vs_crypto_oracle`` hands the
JAX package's arrays to ``ops.selective_copy`` at ``'ref'`` and
``'interpret'``. Its twin builds the same seeded cases with both
packages' ``testing`` helpers, holds the JAX oracle
``selective_copy_crypto_ref`` and the JAX ``ops.selective_copy`` at
``'ref'`` (``'interpret'`` fails on the installed jax) against the port's
``ops.selective_copy`` at ``'ref'`` and ``'auto'`` on CPU tensors: meta
and the whole pool bit-identical int32. The JAX call's
``reserved_scratch=True`` is dropped on the port's side, where the pool's
last row is always the scratch row (a documented difference, ROADMAP.md,
section 3).
"""
import numpy as np
import pytest

import _twin
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import testing as jtesting
from repro_torch.kernels import ops as tops
from repro_torch.kernels import testing as ttesting

PATH = _twin.TESTS / "test_crypto_datapath.py"
KERNEL = "test_kernel_keystream_operand_bit_exact_vs_crypto_oracle"
CASES = _twin.impl_cases(PATH, skip=(KERNEL,))


@pytest.mark.parametrize("case", CASES, ids=[c[3] for c in CASES])
def test_crypto_datapath_twin(case):
    name, jax_params, port_params, _id = case
    _twin.run(PATH, name, jax_params=jax_params, **port_params)


def test_kernel_keystream_operand_matches_jax_oracle():
    jrng, trng = np.random.default_rng(31), np.random.default_rng(31)
    for b, page, pps, meta_max in [(1, 8, 2, 8), (3, 16, 4, 16)]:
        jcase = jtesting.selcopy_crypto_case(jrng, b=b, page=page, pps=pps,
                                             meta_max=meta_max)
        tcase = ttesting.selcopy_crypto_case(trng, b=b, page=page, pps=pps,
                                             meta_max=meta_max)
        for j, t in zip(jcase, tcase):
            assert np.array_equal(np.asarray(j), t)
        stream, ml, tl, pool, tables, ks = jcase
        want = jref.selective_copy_crypto_ref(stream, ml, tl, pool, tables,
                                              ks, meta_max=meta_max)
        outs = {"jax-ref": jops.selective_copy(
            stream, ml, tl, pool, tables, meta_max=meta_max, impl="ref",
            reserved_scratch=True, keystream=ks)}
        for impl in ("ref", "auto"):
            st, tml, ttl, tpool, ttab, tks = ttesting.to_torch(tcase)
            outs[f"port-{impl}"] = tops.selective_copy(
                st, tml, ttl, tpool, ttab, meta_max=meta_max, impl=impl,
                keystream=tks)
        for label, got in outs.items():
            for g, w, tag in zip(got, want, ("meta", "pool")):
                g = np.asarray(g)
                assert g.dtype == np.int32, (label, tag, b)
                assert np.array_equal(g, np.asarray(w)), (label, tag, b)
