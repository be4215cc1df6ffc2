"""Twins of ``tests/test_fused_round.py``: the one-kernel scheduling round.

Every test of the JAX package's file (every parametrised case) runs
through ``repro.core`` and through the port's ``repro_torch.core``
(``device="cpu"``) on the same seeds (``tests/_twin.py``): its own
assertions hold on both sides, and wire bytes, ``CopyCounters``, ``xfer``
counts, ``fused_buffers``, channel, cluster and policy stats and fault
logs are identical. Each end-to-end test runs twice: as written
(``'fused-round:ref'`` and ``'ref'`` on both sides), and with the port
dispatching by the tensors' device (``'fused-round'`` and ``'auto'``,
which take the plain versions on the CPU) against the JAX file as written.

One assertion is replaced on both sides, because the port has no
small-gather host shortcut (ROADMAP.md, section 3: every device-plane
gather runs on the device, and the JAX side runs with
``_SMALL_GATHER_ROWS = 0`` here): in
``test_fused_round_is_one_launch_and_speculates_tx`` a send whose
speculative gather missed is gathered in a device round of its own, so
``device_rounds == fused_rounds`` becomes ``anchor_rounds ==
fused_rounds`` (every anchoring pass is a fused round; no separate anchor
or match launch). With the shortcut off the JAX package counts the same
extra round (6 device rounds for 5 fused ones).

``test_fused_round_interpret_matches_oracle`` hands the JAX package's
arrays to ``ops.fused_round(impl='interpret')``, a TPU mode the port does
not have and that fails on the installed jax (``pl.load``). Its twin
builds the same seeded case with both packages' ``testing`` helpers, holds
the JAX oracle ``fused_round_ref`` and the JAX ``ops.fused_round`` at
``impl='ref'`` (in place of ``'interpret'``) against the port's
``ops.fused_round`` at ``'ref'`` and ``'auto'`` on CPU tensors, at every
``n_buffers`` of the JAX cases (0, 2 and 4): meta, pool, verdict and
gathered payload bit-identical int32.
"""
import numpy as np
import pytest

import _twin
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import testing as jtesting
from repro_torch.kernels import ops as tops
from repro_torch.kernels import testing as ttesting

PATH = _twin.TESTS / "test_fused_round.py"
KERNEL = "test_fused_round_interpret_matches_oracle"
#: the port's side of the second run: dispatch by the tensors' device
DISPATCH = [('"fused-round:ref"', '"fused-round"'),
            ('run("ref"', 'run("auto"')]
#: both sides: a missed speculation's gather is a device round of its own
ONE_LAUNCH = [('assert fx["device_rounds"] == fx["fused_rounds"]',
               'assert fx["anchor_rounds"] == fx["fused_rounds"]')]
SUBS = {"test_fused_round_is_one_launch_and_speculates_tx": ONE_LAUNCH}


@pytest.mark.parametrize("dispatch", [False, True],
                         ids=["as-written", "port-dispatch"])
@pytest.mark.parametrize("case", _twin.cases(PATH, skip=(KERNEL,)),
                         ids=_twin.case_id)
def test_fused_round_twin(case, dispatch):
    name, params = case
    both = SUBS.get(name, [])
    subs = {"jax": both, "torch": both + (DISPATCH if dispatch else [])}
    _twin.run(PATH, name, subs=subs, **params)


def _kernel_args(case, crypto, policy):
    base = (case["stream"], case["meta_len"], case["total_len"],
            case["pool"], case["tables"])
    kw = dict(meta_max=8)
    if crypto:
        kw.update(keystream=case["keystream"],
                  tx_keystream=case["tx_keystream"])
    if policy:
        kw.update(cond_off=case["cond_off"], cond_lo=case["cond_lo"],
                  cond_hi=case["cond_hi"], live=case["live"])
        if crypto:
            kw.update(meta_ks=case["meta_ks"])
    return base, kw


@pytest.mark.parametrize(
    "params", [p for n, p in _twin.cases(PATH) if n == KERNEL],
    ids=lambda p: "-".join(str(v) for v in p.values()))
def test_fused_round_kernel_matches_jax_oracle(params):
    crypto, policy, n_buffers = (params["crypto"], params["policy"],
                                 params["n_buffers"])
    jcase = jtesting.fused_round_case(np.random.default_rng(23), b=2, page=8,
                                      pps=2, meta_max=8)
    tcase = ttesting.fused_round_case(np.random.default_rng(23), b=2, page=8,
                                      pps=2, meta_max=8)
    assert jcase.keys() == tcase.keys()
    for k in jcase:
        assert np.array_equal(np.asarray(jcase[k]), tcase[k]), k
    jbase, jkw = _kernel_args(jcase, crypto, policy)
    want = jref.fused_round_ref(*jbase, **jkw)
    outs = {"jax-ref": jops.fused_round(*jbase, impl="ref",
                                        n_buffers=n_buffers, **jkw)}
    tbase, tkw = _kernel_args(ttesting.to_torch(tcase), crypto, policy)
    for impl in ("ref", "auto"):
        pool = tbase[3].clone()
        outs[f"port-{impl}"] = tops.fused_round(
            *tbase[:3], pool, tbase[4], impl=impl, n_buffers=n_buffers,
            **tkw)
    for label, got in outs.items():
        for gi, wi, tag in zip(got, want, ("meta", "pool", "verdict",
                                           "out")):
            if wi is None:
                assert gi is None, (label, tag)
                continue
            g = np.asarray(gi)
            assert g.dtype == np.int32, (label, tag)
            assert np.array_equal(g, np.asarray(wi)), (label, tag)
