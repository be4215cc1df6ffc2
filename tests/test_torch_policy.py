"""Twins of ``tests/test_policy.py``: the in-data-plane L7 policy engine.

Every test of the JAX package's file (every parametrised case) runs
through ``repro.core`` and through the port's ``repro_torch.core``
(``device="cpu"``) on the same seeds (``tests/_twin.py``): its own
assertions hold on both sides, and wire bytes, ``CopyCounters``, page
counts, ``xfer`` counts, policy and health summaries, cluster stats and
channel stats are identical. The two ``@given`` tests draw each example
once and run it through both packages.

Impls. ``test_hw_ktls_policy_identity[interpret]`` fails on the installed
jax (``TPUMemorySpace``) and names a TPU mode the port does not have: both
sides run it as ``'ref'``. The test also runs the port's ``'auto'`` and
``'fused-round'`` (the JAX side ``'auto'`` and ``'fused-round:ref'``),
which take the plain versions on CPU tensors.
``test_match_impls_agree_on_random_traffic`` loops over ``("ref",
"interpret")`` through ``PolicyTable.match_batch``; the JAX side keeps
that loop (``policy_match``'s interpret mode works), the port loops over
``("ref", "auto")`` on CPU tensors.
"""
import pytest

import _twin

PATH = _twin.TESTS / "test_policy.py"
SUBS = {"test_match_impls_agree_on_random_traffic": {
    "torch": [('for impl in ("ref", "interpret"):',
               'for impl in ("ref", "auto"):')]}}
CASES = _twin.impl_cases(PATH)


@pytest.mark.parametrize("case", CASES, ids=[c[3] for c in CASES])
def test_policy_twin(case):
    name, jax_params, port_params, _id = case
    _twin.run(PATH, name, subs=SUBS.get(name), jax_params=jax_params,
              **port_params)
