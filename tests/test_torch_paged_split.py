"""The algorithm of the CUDA ``paged_attention`` (split-KV over a thread
block cluster), on the CPU.

The kernel (``csrc/paged_attention.cu``) cuts each row's valid keys, in
slot order, into tiles of up to ``TK`` keys of one page (16, or 32 at head
dim 16), and splits the tiles of a (row, KV head) into S contiguous ranges
of equal count (within one), one a block of a cluster. In a block, warp w
keeps its own online softmax over keys w, w + 4, ... of each tile,
rescaled once a tile; the block merges its four warps' partials, and the
cluster its S blocks' partials ``(m, l, acc)``, both in order: ``max`` of
the ``m``, then ``sum x exp(m_s - m)``. This file holds a
torch model of that algorithm against the JAX package's Pallas
``paged_attention`` in interpret mode and its jnp oracle, on the same
numpy-seeded inputs, for S in {1, 2, 3, 4, 8}: group sizes 1, 3 and 4, head
dims 16 to 128, ``-1`` gaps, a page wholly past ``seq_len``, a row with
``seq_len = 0``, a window that empties the early ranges, pages of two
tiles, and tables whose length S does not divide.

The bar is ``atol = rtol = 1e-5``, ten times tighter than the kernel's
(1e-4, the JAX package's bar for float32 paged attention): every side
computes in float32 and differs only in the order of its sums (at most a
few hundred keys a row here), so a fault of the split or the combine, such
as a range counted twice or a partial not rescaled, shows far above it."""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels.ref import NEG_INF

BAR = dict(atol=1e-5, rtol=1e-5)
SPLITS = [1, 2, 3, 4, 8]
WARPS = 4                              # a block's warps: keys w, w + 4, ...


def tile_keys(hd: int) -> int:
    """TK: the kernel's 128 threads score one key with 8 lanes (4 at head
    dim 16, whose rows are 4 float4s)."""
    return 128 // min(8, hd // 4)


def row_tiles(tables, page_pos, seq_len, page, window, tk):
    """The row's valid keys in slot order, as ``(pid, t0, t1)`` tiles of
    at most ``tk`` keys of one page."""
    tiles = []
    for pid, base in zip(tables, page_pos):
        if pid < 0:
            continue
        hi = min(page, seq_len - base + 1)
        lo = max(0, seq_len - window + 1 - base) if window > 0 else 0
        for t0 in range(lo, hi, tk):
            tiles.append((pid, t0, min(hi, t0 + tk)))
    return tiles


def split_ranges(n: int, split: int):
    """Block s of the cluster takes tiles [s n / S, (s + 1) n / S)."""
    return [(s * n // split, (s + 1) * n // split) for s in range(split)]


def empty_partial(hkv, g, hd):
    return (torch.full((hkv, g), NEG_INF), torch.zeros((hkv, g)),
            torch.zeros((hkv, g, hd)))


def warp_partial(qg, pool, tiles, w):
    """Warp ``w``'s online softmax of ``qg [Hkv, G, hd]`` (scaled) over
    keys w, w + 4, ... of each tile, rescaled once a tile."""
    hkv, g, hd = qg.shape
    m, l, acc = empty_partial(hkv, g, hd)
    for pid, t0, t1 in tiles:
        keys = list(range(t0 + w, t1, WARPS))
        if not keys:           # no key of this warp: nothing changes
            continue
        k, v = pool[pid, keys, 0], pool[pid, keys, 1]       # [n, Hkv, hd]
        s = torch.einsum("hgd,nhd->hgn", qg, k)
        mn = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - mn)
        p = torch.exp(s - mn[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("hgn,nhd->hgd", p, v)
        m = mn
    return m, l, acc


def range_partial(qg, pool, tiles):
    """A block's partial over the tiles of its range: its warps' partials
    merged in warp order. A range with no tile gives the empty partial."""
    return combine([warp_partial(qg, pool, tiles, w) for w in range(WARPS)])


def combine(parts):
    """Partials merged in order (a block's warps, a cluster's blocks)."""
    mx = parts[0][0]
    for m, _l, _a in parts[1:]:
        mx = torch.maximum(mx, m)
    l = torch.zeros_like(parts[0][1])
    acc = torch.zeros_like(parts[0][2])
    for m, l_s, acc_s in parts:
        w = torch.exp(m - mx)
        l = l + l_s * w
        acc = acc + acc_s * w[..., None]
    return mx, l, acc


def paged_split(q, pool, tables, page_pos, seq_lens, *, window, split):
    """``paged_attention_ref``'s function as the kernel computes it."""
    b, hq, hd = q.shape
    _p, page, _two, hkv, _hd = pool.shape
    g = hq // hkv
    qs = q * torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    acc = torch.empty((b, hq, hd))
    m = torch.empty((b, hq))
    l = torch.empty((b, hq))
    for i in range(b):
        tiles = row_tiles(tables[i].tolist(), page_pos[i].tolist(),
                          int(seq_lens[i]), page, window, tile_keys(hd))
        parts = [range_partial(qs[i].reshape(hkv, g, hd), pool,
                               tiles[t0:t1])
                 for t0, t1 in split_ranges(len(tiles), split)]
        mi, li, ai = combine(parts)
        m[i], l[i], acc[i] = mi.reshape(hq), li.reshape(hq), \
            ai.reshape(hq, hd)
    return acc, m, l


def _inputs(seed, b, hq, hkv, hd, page, pps, p_total, seq_lens):
    """The layout of tests/test_kernels.py's ``_paged_setup``: row i owns
    distinct pages covering ``seq_lens[i] + 1`` keys, in slot order."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, hd)).astype(np.float32)
    pool = rng.standard_normal((p_total, page, 2, hkv, hd)).astype(
        np.float32)
    tables = np.full((b, pps), -1, np.int32)
    page_pos = np.full((b, pps), -(2 ** 20), np.int32)
    ctr = 0
    for i in range(b):
        for j in range(seq_lens[i] // page + 1):
            tables[i, j] = ctr % p_total
            page_pos[i, j] = j * page
            ctr += 1
    return q, pool, tables, page_pos, np.asarray(seq_lens, np.int32)


def _gaps(case):
    """Row 0: every third slot ``-1``, and after its last page one whose
    keys all lie past ``seq_len``."""
    q, pool, tables, page_pos, seq = case
    page = pool.shape[1]
    n = int(seq[0]) // page + 1
    tables[0, 1:n:3] = -1
    tables[0, n] = pool.shape[0] - 1
    page_pos[0, n] = (n + 1) * page
    return case


# (label, (b, hq, hkv, hd, page, pps, p_total, seq_lens), edit, window)
CASES = [
    ("g1-hd32", (2, 4, 4, 32, 16, 10, 24, [100, 37]), None, 0),
    ("g3-hd128-gaps-past-seq0", (3, 6, 2, 128, 16, 9, 30, [70, 120, 0]),
     _gaps, 0),
    ("g4-hd96-window", (2, 8, 2, 96, 16, 11, 24, [150, 60]), None, 40),
    ("g3-hd32-two-tile-pages", (2, 3, 1, 32, 32, 5, 8, [130, 45]), None, 0),
    ("g4-hd16-window-gaps", (2, 8, 2, 16, 8, 9, 20, [50, 9]), _gaps, 20),
    ("g3-hd128-seq0", (1, 3, 1, 128, 16, 8, 4, [0]), None, 0),
    ("g1-hd64-pps-odd", (3, 2, 2, 64, 16, 13, 40, [190, 3, 64]), None, 0),
]
LABELS = [c[0] for c in CASES]


@functools.lru_cache(maxsize=None)
def _case(label):
    """Inputs of a case, and the Pallas kernel's (interpret mode) and the
    jnp oracle's outputs on them."""
    _l, shape, edit, window = CASES[LABELS.index(label)]
    case = _inputs(sum(map(ord, label)), *shape)
    if edit is not None:
        case = edit(case)
    args = tuple(map(jnp.asarray, case))
    wants = [jops.paged_attention(*args, window=window, impl="interpret"),
             jref.paged_attention_ref(*args, window=window)]
    return case, window, [[np.asarray(x, np.float32) for x in w]
                          for w in wants]


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("label", LABELS)
def test_split_model_matches_pallas_and_oracle(label, split):
    case, window, wants = _case(label)
    got = paged_split(*map(torch.from_numpy, case), window=window,
                      split=split)
    for want in wants:                     # Pallas interpret, jnp oracle
        for w, t in zip(want, got):
            np.testing.assert_allclose(t.numpy(), w, **BAR)


def test_split_ranges_are_contiguous_and_even():
    """The S ranges cover the tiles once, in order, and their sizes differ
    by at most one; seven of eight are empty for a row of one tile."""
    for n in (0, 1, 5, 8, 66, 67):
        for split in SPLITS:
            rs = split_ranges(n, split)
            assert rs[0][0] == 0 and rs[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(rs, rs[1:]))
            sizes = [t1 - t0 for t0, t1 in rs]
            assert max(sizes) - min(sizes) <= (1 if n else 0)
    assert [t1 - t0 for t0, t1 in split_ranges(1, 8)].count(0) == 7


def test_empty_range_adds_exactly_nothing():
    """A range with no valid key (m = -1e30, l = 0, acc = 0) combines to
    the same bits as leaving it out, wherever it stands."""
    case, window, _w = _case("g3-hd128-gaps-past-seq0")
    q, pool, tables, page_pos, seq = map(torch.from_numpy, case)
    hkv, hd = pool.shape[3], pool.shape[4]
    g = q.shape[1] // hkv
    qg = (q[1] * torch.tensor(1.0 / math.sqrt(hd))).reshape(hkv, g, hd)
    tiles = row_tiles(tables[1].tolist(), page_pos[1].tolist(), int(seq[1]),
                      pool.shape[1], window, tile_keys(hd))
    a = range_partial(qg, pool, tiles[:3])
    b = range_partial(qg, pool, tiles[3:])
    e = range_partial(qg, pool, [])
    assert torch.equal(e[0], torch.full((hkv, g), NEG_INF))
    assert not e[1].any() and not e[2].any()
    want = combine([a, b])
    for parts in ([e, a, b], [a, e, b], [a, b, e], [e, e, a, e, b, e]):
        for x, y in zip(combine(parts), want):
            assert torch.equal(x, y)


@pytest.mark.parametrize("split", SPLITS)
def test_row_without_valid_key_gives_zero_and_no_nan(split):
    """A row whose slots are all -1 or all past ``seq_len`` gives acc = 0,
    l = 0, m = -1e30 and no NaN, as the reference does."""
    q, pool, tables, page_pos, seq = _inputs(5, 2, 6, 2, 32, 8, 4, 6,
                                             [20, 10])
    tables[0] = -1                          # no page at all
    page_pos[1] = [40, 48, 56, 64]          # every key past seq_len
    case = (q, pool, tables, page_pos, seq)
    acc, m, l = paged_split(*map(torch.from_numpy, case), window=0,
                            split=split)
    assert not torch.isnan(acc).any()
    assert not acc.any() and not l.any()
    assert torch.equal(m, torch.full_like(m, NEG_INF))
    want = jref.paged_attention_ref(*map(jnp.asarray, case))
    for w, t in zip(want, (acc, m, l)):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), **BAR)
