"""Twins of ``tests/test_device_pool.py``: the resident device pool.

Every test of the JAX package's file (every parametrised case) runs
through ``repro.core`` and through the port's ``repro_torch.core``
(``device="cpu"``) on the same seeds (``tests/_twin.py``): its own
assertions hold on both sides, and wire bytes, ``CopyCounters``, page
counts, ``xfer`` counts and ``fused_buffers`` are identical.

Impls. The ``[interpret]`` cases fail on the installed jax (``pl.load``)
and name a TPU mode the port does not have: both sides run them as
``'ref'``. Each test with an ``impl`` grid also runs the port's ``'auto'``
and ``'fused-round'`` (the JAX side ``'auto'`` and ``'fused-round:ref'``),
which take the plain versions on CPU tensors. Tests that run a fixed
``impl="ref"`` in their body run once more with the port at ``'auto'``
(``-port-dispatch``). ``test_forward_batch_device_gather_matches_host_gather``
loops over ``("ref", "interpret")``; the JAX side keeps that loop (the
gather's interpret mode works), the port loops over ``("ref", "auto")``.

Deliberate differences (ROADMAP.md, section 3), each replacing one JAX
assertion with the port's own statement on the port's side:

* ``xfer['donated_rounds']`` counts every device round whose pool keeps
  its storage (the pool is updated in place), not only donated anchor
  rounds: in ``test_resident_anchor_rounds_donate_the_pool_buffer`` and
  ``test_donation_composes_with_hw_ktls_keystream_rounds`` the port
  asserts ``donated_rounds == device_rounds`` where JAX asserts
  ``donated_rounds == anchor_rounds``. ``donated_rounds`` is the one
  ``xfer`` key the twins do not compare.
* There is no small-gather host shortcut: the JAX side runs with
  ``_SMALL_GATHER_ROWS = 0`` (``tests/_twin.py`` sets it), so the two
  tests that pin it to 0 with ``monkeypatch`` have that line and their
  ``monkeypatch`` argument rewritten away on both sides
  (``NO_SMALL_GATHER``): on the JAX side the line repeated what the twin
  runner does, and the port has no such attribute.
"""
import pytest

import _twin

PATH = _twin.TESTS / "test_device_pool.py"
DONATED = [('x["donated_rounds"] == x["anchor_rounds"]',
            'x["donated_rounds"] == x["device_rounds"]')]
#: the two tests that pin the small-gather shortcut off, already off
NO_SMALL_GATHER = [
    ("(monkeypatch):", "():"),
    ('monkeypatch.setattr("repro.core.stack._SMALL_GATHER_ROWS", 0)',
     "pass")]
SUBS = {
    "test_host_writes_interleave_with_device_rounds": {
        "jax": NO_SMALL_GATHER, "torch": NO_SMALL_GATHER},
    "test_out_of_range_rows_bounce_round_to_host": {
        "jax": NO_SMALL_GATHER, "torch": NO_SMALL_GATHER},
    "test_forward_batch_device_gather_matches_host_gather": {
        "torch": [('for impl in ("ref", "interpret"):',
                   'for impl in ("ref", "auto"):')]},
    "test_resident_anchor_rounds_donate_the_pool_buffer": {"torch": DONATED},
    "test_donation_composes_with_hw_ktls_keystream_rounds": {
        "torch": DONATED},
}
#: tests that run a fixed impl="ref" in their body
DISPATCH = ("test_legacy_host_pool_pays_pool_syncs",
            "test_device_rounds_materialize_lazily_for_host_views",
            "test_host_writes_interleave_with_device_rounds",
            "test_out_of_range_rows_bounce_round_to_host",
            "test_int64_rows_survive_device_round_reusing_them",
            "test_whole_pool_view_writes_stay_coherent_with_device_rounds",
            "test_resident_anchor_rounds_donate_the_pool_buffer",
            "test_donation_composes_with_hw_ktls_keystream_rounds")


CASES = _twin.impl_cases(PATH)


@pytest.mark.parametrize("case", CASES, ids=[c[3] for c in CASES])
def test_device_pool_twin(case):
    name, jax_params, port_params, _id = case
    _twin.run(PATH, name, subs=SUBS.get(name), jax_params=jax_params,
              **port_params)


@pytest.mark.parametrize("name", DISPATCH)
def test_device_pool_twin_port_dispatch(name):
    subs = dict(SUBS.get(name, {}))
    subs["torch"] = subs.get("torch", []) + [('impl="ref"', 'impl="auto"')]
    _twin.run(PATH, name, subs=subs)
