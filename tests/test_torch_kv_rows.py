"""``PagedKVPool``'s per-step metadata (``batch_tables``, ``write_coords``,
``token_coords``) is built from each handle's page list once and kept on
the handle; these tests hold it to ``AnchorPool``'s walks over the same
page lists, which the JAX-parity tests pin, as the lists grow and are
released and allocated again."""
import random

import numpy as np
import pytest

from repro_torch.core.anchor_pool import AnchorPool, PageRef
from repro_torch.serving.kv_cache import PagedKVPool, SeqHandle

PAGE = 8


class _Model:
    """What ``PagedKVPool`` asks of a model: its page size and pool shape."""
    page_size = PAGE

    @staticmethod
    def kv_pool_shape(pages):
        return (1, pages)


def _pool(n_shards, pages_per_shard=96):
    alloc = AnchorPool(n_shards, pages_per_shard, PAGE, high_watermark=1.0)
    return PagedKVPool(_Model(), alloc=alloc, page_size=PAGE, device="cpu")


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_cached_rows_match_the_allocator_walks(n_shards):
    """Decode steps over a changing batch: handles admitted, grown past
    their reservation by ``extend``, released and their pages reused. At
    every step the three arrays equal the allocator's, at two ``pps``."""
    rng = random.Random(n_shards)
    kv = _pool(n_shards)
    live, pps = [], 40
    for step in range(60):
        if len(live) < 6 and rng.random() < 0.5:
            try:
                live.append(kv.anchor_sequence(rng.randint(0, 60), 0,
                                               reserve=rng.randint(0, 12)))
            except Exception:   # pool exhausted: decode what is there
                pass
        if live and rng.random() < 0.15:
            kv.release(live.pop(rng.randrange(len(live))))
        for h in live:
            kv.extend(h, h.seq_len + rng.randint(0, 3))
        handles = [h for h in live if h.pages]
        pages = [h.pages for h in handles]
        for p in (pps, None):
            _same(kv.batch_tables(handles, p), kv.alloc.tables_for(pages, p))
        pos = [h.seq_len - 1 for h in handles]
        _same(kv.write_coords(handles, pos),
              AnchorPool.write_coords(pages, pos, n_shards, PAGE))
        width = rng.choice([PAGE, 3 * PAGE, 9 * PAGE])
        _same(kv.token_coords(live, width),
              kv.alloc.token_coords([h.pages for h in live], width))
    # a step with no handles keeps the allocator's empty shapes
    _same(kv.batch_tables([], pps), kv.alloc.tables_for([], pps))


def test_cached_rows_follow_a_list_that_grew_or_was_replaced():
    kv = _pool(1)
    h = kv.anchor_sequence(16, 0)
    first = kv.batch_tables([h], 8)
    kv.extend(h, 30)                     # two pages more
    _same(kv.batch_tables([h], 8), kv.alloc.tables_for([h.pages], 8))
    assert not np.array_equal(first[0], kv.batch_tables([h], 8)[0])
    h.pages = list(reversed(h.pages))    # another list, the same length
    _same(kv.batch_tables([h], 8), kv.alloc.tables_for([h.pages], 8))
    _same(kv.write_coords([h], [17]),
          AnchorPool.write_coords([h.pages], [17], 1, PAGE))


def test_overlapping_or_missing_pages_are_judged_as_the_allocator_does():
    """Pages that overlap: a position held by one of them resolves, one
    held by two (or by none) asserts, and the token coordinates keep the
    last page in list order, all as ``AnchorPool``'s walks."""
    kv = _pool(1)
    h = SeqHandle(0, [PageRef(0, 1, 0), PageRef(0, 2, 4)], 12, 0)
    _same(kv.write_coords([h], [2]),
          AnchorPool.write_coords([h.pages], [2], 1, PAGE))
    for pos in (6, 40):
        with pytest.raises(AssertionError):
            kv.write_coords([h], [pos])
    _same(kv.token_coords([h], 16), kv.alloc.token_coords([h.pages], 16))
    gap = SeqHandle(0, [PageRef(0, 3, 0), PageRef(0, 4, 16)], 20, 0)
    with pytest.raises(AssertionError):
        kv.write_coords([gap], [9])
    _same(kv.token_coords([gap], 24), kv.alloc.token_coords([gap.pages], 24))
