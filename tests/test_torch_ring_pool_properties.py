"""Twins of ``tests/test_ring_pool_properties.py``, its receive-ring and
batch-allocator properties: each of its tests (every parametrised case;
each hypothesis example drawn once and replayed on the port) runs
through the JAX package's ``repro.core`` and through the port's
``repro_torch.core`` on the same seeds. Its own assertions hold on both
sides, and the objects it builds end the same (``tests/_twin.py``). Plus
a property twin of the grant pins (``export_grant`` /
``release_export``) that the cluster's zero-copy grants lean on."""
import pytest

import _twin
from _hypothesis_compat import given, settings, st
from repro.core import AnchorPool as JAnchorPool
from repro_torch.core import AnchorPool as TAnchorPool

PATH = _twin.TESTS / "test_ring_pool_properties.py"


@pytest.mark.parametrize("case", _twin.cases(PATH), ids=_twin.case_id)
def test_ring_pool_properties_twin(case):
    name, params = case
    _twin.run(PATH, name, **params)


# ---------------------------------------------------------------------------
# grant pins, which the cluster's zero-copy grants lean on
# ---------------------------------------------------------------------------

def _pool_state(pool):
    return (pool.free_pages, pool.granted_out_pages, pool.accounted_pages,
            dict(pool._refcount), dict(pool.stats))


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(1, 80), min_size=1, max_size=12), st.data())
def test_grant_pins_match_jax(sizes, data):
    """Random interleavings of ``alloc_sequence``, ``export_grant``,
    ``release_export`` and ``free_pages_list`` leave the two packages'
    pools in the same state after every step: a page returns to the
    freelist only when its owner's reference and every pin are gone, and
    ``granted_out_pages`` counts the pins outstanding."""
    pools = [JAnchorPool(4, 16, 8, max_pages_per_seq=6),
             TAnchorPool(4, 16, 8, max_pages_per_seq=6)]
    seqs = [[], []]
    for n in sizes:
        for pool, held in zip(pools, seqs):
            try:
                held.append([pool.alloc_sequence(n), True, 0])
            except Exception:
                held.append(None)
    assert _pool_state(pools[0]) == _pool_state(pools[1])
    live = [i for i, s in enumerate(seqs[0]) if s is not None]
    for _ in range(3 * len(live)):
        if not live:
            break
        i = data.draw(st.sampled_from(live))
        op = data.draw(st.sampled_from(("pin", "unpin", "free")))
        for pool, held in zip(pools, seqs):
            pages, owned, pins = held[i]
            if op == "pin" and (owned or pins):
                pool.export_grant(pages)
                held[i][2] += 1
            elif op == "unpin" and pins:
                pool.release_export(pages)
                held[i][2] -= 1
            elif op == "free" and owned:
                pool.free_pages_list(pages)
                held[i][1] = False
        assert _pool_state(pools[0]) == _pool_state(pools[1])
    for pool, held in zip(pools, seqs):
        for s in held:
            if s is None:
                continue
            pages, owned, pins = s
            for _ in range(pins):
                pool.release_export(pages)
            if owned:
                pool.free_pages_list(pages)
        assert pool.granted_out_pages == 0
        assert pool.free_pages == pool.total_pages
    assert _pool_state(pools[0]) == _pool_state(pools[1])
