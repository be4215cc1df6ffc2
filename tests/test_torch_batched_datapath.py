"""Twins of ``tests/test_batched_datapath.py``: the batched datapath.

Every test of the JAX package's file runs through ``repro.core`` and
through the port's ``repro_torch.core`` (``device="cpu"``) on the same
seeds (``tests/_twin.py``): its own assertions hold on both sides, and
wire bytes, ``CopyCounters``, page counts, ``xfer`` counts,
``fused_buffers``, receive rings and channel stats are identical.

Impls. ``test_recv_batch_kernel_impls_match_host`` loops over ``("ref",
"interpret")``, and its interpret pass fails on the installed jax
(``pl.load``); the port has no TPU mode. Both sides loop over four impls
instead: ``'ref'``, ``'ref'`` for ``'interpret'``, then the port's
``'auto'`` and ``'fused-round'`` against the JAX side's ``'auto'`` and
``'fused-round:ref'``. The two tests that run a fixed ``impl="ref"`` run
once more with the port at ``'auto'`` (``-port-dispatch``).
"""
import pytest

import _twin

PATH = _twin.TESTS / "test_batched_datapath.py"
LOOP = 'for impl in ("ref", "interpret"):'
SUBS = {"test_recv_batch_kernel_impls_match_host": {
    "jax": [(LOOP, 'for impl in ("ref", "ref", "auto", "fused-round:ref"):')],
    "torch": [(LOOP, 'for impl in ("ref", "ref", "auto", "fused-round"):')],
}}
#: tests that run a fixed impl="ref" in their body
DISPATCH = ("test_recv_batch_device_impl_preserves_int64_pool_rows",
            "test_recv_batch_device_overflow_falls_back_to_host")


@pytest.mark.parametrize("case", _twin.cases(PATH), ids=_twin.case_id)
def test_batched_datapath_twin(case):
    name, params = case
    _twin.run(PATH, name, subs=SUBS.get(name), **params)


@pytest.mark.parametrize("name", DISPATCH)
def test_batched_datapath_twin_port_dispatch(name):
    _twin.run(PATH, name, subs={"torch": [('impl="ref"', 'impl="auto"')]})
