"""The algorithm of the CUDA ``fused_round`` (persistent blocks walking
page tiles through a shared-memory ring), on the CPU.

The kernel (``csrc/fused_round.cu``, the walk in ``csrc/datapath.cuh``)
numbers its tasks row by row: one metadata-and-verdict task first in each
row, then a tile of at most ``TILE`` tokens of each page of the row. Block
k of G walks tasks ``[k P + min(k, E), (k + 1) P + min(k + 1, E))`` with
``P, E = divmod(T, G)``; task i of a block's range goes into slot ``i %
D`` of its ring, its copies issued ``D - 1`` tasks ahead, after the block
barrier that follows the last read of the slot's previous task. A window
is copied as its 16-byte-aligned cover (the bulk path) or exactly (the
4-byte path) and read back at the shift.

This file holds a numpy model of that walk, with the kernel's index
arithmetic, against the JAX package's jnp oracle ``fused_round_ref`` on
the same numpy-seeded inputs, bit for bit: ring depths 2, 3 and 4, 1, 3
and 132 blocks, ``meta_len % 4 != 0``, ``S % 4 != 0``, pages of 8 and
1024 tokens, pages of several tiles, with and without keystreams and the
policy table. Each slot word the model reads must have been copied for
the task reading it, and no slot is refilled before its task has been
read. It also pins ``ops.fused_round``'s ``n_buffers`` contract on CPU
tensors and the shared-memory layout the wrapper checks."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import selective_copy as kern
from repro_torch.kernels import testing as tt

TILE = kern.TILE
PAD, PAYLOAD_BASE = -1, -2


def up4(n):
    return (n + 3) // 4 * 4


def window(lo, hi, bulk):
    """(base, words): slot word 0 holds token ``base``."""
    if hi <= lo:
        return lo, 0
    base, end = (lo // 4 * 4, up4(hi)) if bulk else (lo, hi)
    return base, end - base


class Slot:
    """A ring slot: the words copied for its current task, and a mark of
    which words those are."""

    def __init__(self, words):
        self.data = np.zeros(words, np.int64)
        self.ok = np.zeros(words, bool)
        self.task = None

    def fill(self, task, copies):
        self.data[:] = -(1 << 40)      # poison: no value of any task
        self.ok[:] = False
        self.task = task
        for off, src in copies:
            assert off + len(src) <= len(self.data), "window past the slot"
            self.data[off:off + len(src)] = src
            self.ok[off:off + len(src)] = True

    def __getitem__(self, i):
        assert 0 <= i < len(self.data) and self.ok[i], \
            f"slot word {i} was not copied for task {self.task}"
        return int(self.data[i])


def ring_walk(tasks, blocks, depth, slot_words, load, plan, consume, log,
              ahead=None):
    """The kernels' walk, block after block (blocks share no state but
    the outputs). ``plan(t, prm)`` returns the task's copies as (slot
    offset, source tokens); ``consume(t, prm, slot)`` computes it. The
    copies go out ``ahead`` tasks early: ``depth - 1`` in the kernels."""
    ahead = depth - 1 if ahead is None else ahead
    per, extra = divmod(tasks, blocks)
    for k in range(blocks):
        t0 = k * per + min(k, extra)
        t1 = t0 + per + (k < extra)
        n = t1 - t0
        ring = [Slot(slot_words) for _ in range(depth)]
        read = [True] * depth          # the slot's last task has been read
        hdr = [None] * depth

        def issue(i):
            s = i % depth
            assert read[s], f"slot {s} refilled before task {ring[s].task}"
            hdr[s] = load(t0 + i)
            ring[s].fill(t0 + i, plan(t0 + i, hdr[s]))
            read[s] = False
            log.append(("issue", k, t0 + i, s))

        for i in range(min(ahead, n)):
            issue(i)
        for i in range(n):
            if i + ahead < n:          # after the barrier that ends task i-1
                issue(i + ahead)
            s = i % depth
            assert ring[s].task == t0 + i
            consume(t0 + i, hdr[s], ring[s])
            read[s] = True
            log.append(("read", k, t0 + i, s))


# ---------------------------------------------------------------------------
# fused_round
# ---------------------------------------------------------------------------

def cond_holds(off, lo, hi, mlen, m, plen, w, meta_at, pay_at):
    if off == PAD:
        return True
    if off >= 0:
        return off < mlen and off < m and lo <= meta_at(off) <= hi
    pos = PAYLOAD_BASE - off
    return pos < plen and pos < w and lo <= pay_at(pos) <= hi


def first_match(c, mlen, m, plen, w, meta_at, pay_at):
    off, lo, hi, live = c
    r, k = off.shape
    for rule in range(r):
        if live is not None and live[rule] <= 0:
            continue
        if all(cond_holds(int(off[rule, j]), int(lo[rule, j]),
                          int(hi[rule, j]), mlen, m, plen, w, meta_at,
                          pay_at) for j in range(k)):
            return rule
    return r


def fused_model(case, keys, *, meta_max, depth, blocks, bulk, tile,
                log=None):
    """``(meta, pool, verdict | None, out)`` of the kernel's walk; the
    pool is updated in place (a copy of the case's)."""
    stream, pool = case["stream"], case["pool"].copy()
    ml, tl, tables = case["meta_len"], case["total_len"], case["tables"]
    ks = case["keystream"] if "keystream" in keys else None
    txks = case["tx_keystream"] if "tx_keystream" in keys else None
    policy = "cond_off" in keys
    live_col = case["live"] if "live" in keys else None
    mks = case["meta_ks"] if "meta_ks" in keys else None
    b, s = stream.shape
    p_ext, page = pool.shape
    pps = tables.shape[1]
    tpp = -(-page // tile)
    row_tasks = 1 + pps * tpp
    # the slot layout of ring_layout (csrc/fused_round.cu)
    tw = up4(min(page, tile)) + 4
    mw = up4(min(meta_max, tile))
    off_ks = tw
    off_meta = tw * (1 + (ks is not None)) if policy else 0
    off_mks = off_meta + mw
    slot_words = max(tw * (1 + (ks is not None)),
                     off_mks + (mw if policy and mks is not None else 0))
    meta = np.full((b, meta_max), 7, np.int64)
    out = np.full((b, pps * page), 7, np.int64)
    verdict = np.full(b, 7, np.int64) if policy else None

    def task(t):
        bb, r = divmod(t, row_tasks)
        if r == 0:
            return bb, -1, 0, 0
        jj, q = divmod(r - 1, tpp)
        return bb, jj, q * tile, min(tile, page - q * tile)

    def meta_staged(mlen):
        return min(max(min(mlen, meta_max), 0), s, tile)

    def pay_staged(plen):
        return max(min(plen, page, tile), 0)

    def first_page_window(mlen, plen):
        wp = pay_staged(plen)
        if wp == 0:
            return 0, 0
        lo = min(max(mlen, 0), s - 1)
        hi = min(mlen + wp, s)
        return window(lo, hi if hi > lo else lo + 1, bulk)

    def tile_window(jj, lo_, n, pid, mlen, tlen):
        if pid < 0 or pid >= p_ext:
            return 0, 0
        rel0 = jj * page + lo_
        live = int(np.clip(tlen - mlen - rel0, 0, n))
        lo, hi = max(mlen + rel0, 0), min(mlen + rel0 + live, s)
        return window(lo, hi, bulk)

    def load(t):
        bb, jj, _lo, _n = task(t)
        pid = 0 if jj < 0 else int(tables[bb, jj])
        return pid, int(ml[bb]), int(tl[bb])

    def plan(t, prm):
        bb, jj, lo_, n = task(t)
        pid, mlen, tlen = prm
        copies = []
        if jj >= 0:
            base, words = tile_window(jj, lo_, n, pid, mlen, tlen)
            if words:
                assert base + words <= s, "cover past the row"
                copies.append((0, stream[bb, base:base + words]))
                if ks is not None:
                    copies.append((off_ks, ks[bb, base:base + words]))
            return copies
        nm = meta_staged(mlen)
        if nm:
            w = up4(nm) if bulk else nm
            assert w <= s
            copies.append((off_meta, stream[bb, :w]))
        if not policy:
            return copies
        nk = min(min(mlen, meta_max), tile)
        if mks is not None and nk > 0:
            copies.append((off_mks, mks[bb, :up4(nk) if bulk else nk]))
        base, words = first_page_window(mlen, tlen - mlen)
        if words:
            assert base + words <= s, "cover past the row"
            copies.append((0, stream[bb, base:base + words]))
            if ks is not None:
                copies.append((off_ks, ks[bb, base:base + words]))
        return copies

    def tile_task(bb, jj, lo_, n, prm, slot):
        pid, mlen, tlen = prm
        plen = tlen - mlen
        has, writable = pid >= 0, 0 <= pid < p_ext
        rd = 0 if not has else min(pid, p_ext - 1)
        rel0 = jj * page + lo_
        nlive = int(np.clip(plen - rel0, 0, n)) if has else 0
        base, _w = tile_window(jj, lo_, n, pid, mlen, tlen)
        obase = jj * page + lo_
        for l in range(n):
            o = 0
            if l < nlive:
                pos = mlen + rel0 + l
                if writable and 0 <= pos < s:
                    i = pos - base
                    v = slot[i] ^ (slot[off_ks + i] if ks is not None else 0)
                    pool[rd, lo_ + l] = v
                else:
                    v = int(pool[rd, lo_ + l])   # an edge lane: the pool's
                o = v ^ (int(txks[bb, obase + l]) if txks is not None else 0)
            out[bb, obase + l] = o

    def meta_task(bb, prm, slot):
        _pid, mlen, tlen = prm
        plen = tlen - mlen
        nm = meta_staged(mlen)

        def meta_tok(i):
            src = min(i, s - 1)
            return slot[off_meta + src] if src < nm else int(stream[bb, src])
        for i in range(meta_max):
            meta[bb, i] = meta_tok(i) if i < mlen else 0
        if not policy:
            return
        nk = min(min(mlen, meta_max), tile)
        wp = pay_staged(plen)
        wbase, _w = first_page_window(mlen, plen)

        def meta_at(o):
            v = meta_tok(o)
            if mks is None:
                return v
            return v ^ (slot[off_mks + o] if o < nk else int(mks[bb, o]))

        def pay_at(p):
            pos = min(max(mlen + p, 0), s - 1)
            if p < wp:
                i = pos - wbase
                return slot[i] ^ (slot[off_ks + i] if ks is not None else 0)
            return int(stream[bb, pos]) ^ (int(ks[bb, pos])
                                           if ks is not None else 0)
        verdict[bb] = first_match(
            (case["cond_off"], case["cond_lo"], case["cond_hi"], live_col),
            mlen, meta_max, plen, page, meta_at, pay_at)

    def consume(t, prm, slot):
        bb, jj, lo_, n = task(t)
        if jj < 0:
            meta_task(bb, prm, slot)
        else:
            tile_task(bb, jj, lo_, n, prm, slot)

    ring_walk(b * row_tasks, min(blocks, b * row_tasks), depth, slot_words,
              load, plan, consume, [] if log is None else log)
    return (meta.astype(np.int32), pool,
            None if verdict is None else verdict.astype(np.int32),
            out.astype(np.int32))


OPERANDS = {
    "none": (),
    "crypto": ("keystream", "tx_keystream"),
    "policy": ("cond_off", "cond_lo", "cond_hi"),
    "all": ("keystream", "tx_keystream", "cond_off", "cond_lo", "cond_hi",
            "live", "meta_ks"),
}


def _fused_cases():
    """(id, case, meta_max, tile, bulk): meta_max 16 and 8 (S % 4 == 0,
    meta_len of any alignment: the bulk path's shifted covers), 5 and 7
    (S % 4 != 0: the 4-byte path), pages of 8 and 1024 tokens, and pages
    of three tiles of a tile of 8."""
    rng = np.random.default_rng(7)
    return [
        ("p8-m16", tt.fused_round_case(rng, b=4, page=8, pps=4,
                                       meta_max=16), 16, TILE, True),
        ("p8-m5-odd-s", tt.fused_round_case(rng, b=5, page=8, pps=3,
                                            meta_max=5), 5, TILE, False),
        ("edge-m8", tt.edge_fused_round_case(), 8, TILE, True),
        ("edge-m7-odd-s", tt.edge_fused_round_case(meta_max=7), 7, TILE,
         False),
        ("p1024-m8", tt.fused_round_case(rng, b=3, page=1024, pps=2,
                                         meta_max=8, r=4, k=2), 8, TILE,
         True),
        ("p24-3tiles", tt.fused_round_case(rng, b=4, page=24, pps=3,
                                           meta_max=12), 12, 8, True),
        ("p24-3tiles-4byte", tt.fused_round_case(rng, b=4, page=24, pps=3,
                                                 meta_max=12), 12, 8, False),
    ]


FUSED_CASES = _fused_cases()


def _jax_fused(case, keys, meta_max):
    base = ("stream", "meta_len", "total_len", "pool", "tables")
    return jref.fused_round_ref(*(jnp.asarray(case[k]) for k in base),
                                meta_max=meta_max,
                                **{k: jnp.asarray(case[k]) for k in keys})


def _same_round(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert np.array_equal(g, np.asarray(w))


@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("blocks", [1, 3, 132])
@pytest.mark.parametrize("operands", list(OPERANDS))
@pytest.mark.parametrize("cid", [c[0] for c in FUSED_CASES])
def test_fused_ring_matches_jax(cid, operands, blocks, depth):
    _id, case, meta_max, tile, bulk = next(c for c in FUSED_CASES
                                           if c[0] == cid)
    keys = OPERANDS[operands]
    log = []
    got = fused_model(case, keys, meta_max=meta_max, depth=depth,
                      blocks=blocks, bulk=bulk, tile=tile, log=log)
    _same_round(got, _jax_fused(case, keys, meta_max))
    b, pps = case["tables"].shape
    tasks = b * (1 + pps * -(-case["pool"].shape[1] // tile))
    assert sorted(e[2] for e in log if e[0] == "read") == list(range(tasks))


def test_ring_schedule_issues_depth_minus_one_ahead():
    """In a block's range, task i's copies go out right after task
    i - depth + 1 is read (before the first task at the start), into slot
    i % depth; the walk never reads a slot before it is filled."""
    _id, case, meta_max, tile, bulk = FUSED_CASES[0]
    for depth in (2, 3, 4):
        log = []
        fused_model(case, OPERANDS["all"], meta_max=meta_max, depth=depth,
                    blocks=3, bulk=bulk, tile=tile, log=log)
        for blk in range(3):
            ev = [e for e in log if e[1] == blk]
            t0 = ev[0][2]
            order = [(kind, t - t0) for kind, _b, t, _s in ev]
            n = sum(kind == "read" for kind, _ in order)
            want = [("issue", i) for i in range(min(depth - 1, n))]
            for i in range(n):
                if i + depth - 1 < n:
                    want.append(("issue", i + depth - 1))
                want.append(("read", i))
            assert order == want
            assert all(s == (t - t0) % depth for _k, _b, t, s in ev)


def test_ring_slot_refill_before_read_is_caught():
    """The model's guard fires when a walk refills a slot whose task has
    not been read: copies issued depth tasks ahead instead of depth - 1."""
    with pytest.raises(AssertionError, match="refilled before task 0"):
        ring_walk(9, 1, 2, 8, lambda t: t, lambda t, prm: [],
                  lambda t, prm, slot: None, [], ahead=2)


# ---------------------------------------------------------------------------
# ops.fused_round's n_buffers on CPU tensors, and the wrapper's layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_buffers", [0, 2, 3, 4])
@pytest.mark.parametrize("operands", ["none", "all"])
def test_ops_fused_round_n_buffers_matches_jax(n_buffers, operands):
    case = tt.fused_round_case(np.random.default_rng(5), b=4, page=8, pps=3,
                               meta_max=8)
    keys = OPERANDS[operands]
    c = tt.to_torch(case)
    got = ops.fused_round(c["stream"], c["meta_len"], c["total_len"],
                          c["pool"], c["tables"], meta_max=8,
                          n_buffers=n_buffers, **{k: c[k] for k in keys})
    _same_round([None if g is None else g.numpy() for g in got],
                _jax_fused(case, keys, 8))


@pytest.mark.parametrize("n_buffers", [1, -1, -4])
@pytest.mark.parametrize("impl", ["ref", "auto", "cuda"])
def test_ops_fused_round_refuses_depth_one_and_negative(n_buffers, impl):
    c = tt.to_torch(tt.fused_round_case(np.random.default_rng(5), b=2,
                                        page=8, pps=2, meta_max=8))
    with pytest.raises(ValueError, match="n_buffers"):
        ops.fused_round(c["stream"], c["meta_len"], c["total_len"],
                        c["pool"], c["tables"], meta_max=8, impl=impl,
                        n_buffers=n_buffers)


def test_ring_depth_default_and_passthrough():
    assert kern.ring_depth(0) == kern.DEFAULT_FUSED_DEPTH >= 2
    assert [kern.ring_depth(d) for d in (2, 3, 7)] == [2, 3, 7]


@pytest.mark.parametrize("cid", [c[0] for c in FUSED_CASES])
def test_smem_bytes_hold_the_models_slots(cid):
    """The wrapper's shared-memory count is the model's slots, a 32-byte
    task record and an 8-byte barrier a slot, two staged records, and the
    table that fits the budget; a 70 x 40 table does not
    fit and adds nothing."""
    _id, case, meta_max, _tile, _bulk = next(c for c in FUSED_CASES
                                             if c[0] == cid)
    page = case["pool"].shape[1]
    r, k = case["cond_off"].shape
    tw = up4(min(page, TILE)) + 4
    mw = up4(min(meta_max, TILE))
    for depth in (2, 3, 4):
        got = kern.fused_round_smem_bytes(
            depth, page=page, meta_max=meta_max, has_ks=True,
            has_policy=True, has_meta_ks=True, r=r, k=k)
        slot = 2 * tw + 2 * mw
        assert got == depth * (4 * slot + 40) + 64 + up4(4 * (3 * r * k + r))
        plain = kern.fused_round_smem_bytes(
            depth, page=page, meta_max=meta_max, has_ks=False,
            has_policy=False, has_meta_ks=False, r=0, k=0)
        assert plain == depth * (4 * max(tw, mw) + 40) + 64
    wide = kern.fused_round_smem_bytes(2, page=16, meta_max=40, has_ks=True,
                                       has_policy=True, has_meta_ks=True,
                                       r=70, k=40)
    assert wide == 2 * (4 * (2 * 20 + 2 * 40) + 40) + 64
