"""The algorithms of the CUDA ``selective_copy`` and ``policy_match``
(``csrc/selective_copy.cu``, ``csrc/policy_match.cu``), on the CPU.

``selective_copy``: block (b, 0) compacts row b's metadata, one token a
thread, its loads issued before ``meta_len`` is known; block (b, j >= 1)
anchors page j - 1 of row b. A thread owns groups of 4 tokens of the page
(``page_threads(groups)`` threads, 1, 2 or 4 groups a thread a pass) and
loads every word of its pass that is payload (one load a word, stream and
keystream) before it stores any. A group whose four words are all
payload stores as one int4 when the pool rows are 16-byte aligned, else
word by word.

``policy_match``: one warp a message; lane i takes the flattened (rule,
cond) entries i, i + 32, ... of a chunk of 32 rules, ``KBATCH`` at a time;
a failing entry sets its rule's flag; the first rule whose flag is clear
is ``__ffs`` of the chunk's ballot. Rows that fit the shared-memory
budget are staged, others read at the condition.

The numpy models below carry the kernels' index arithmetic and are held
bit for bit to the JAX package's oracles (``selective_copy_ref``,
``selective_copy_crypto_ref``, ``policy_match_ref``) on numpy-seeded
inputs. The copy model poisons every word it did not load and checks that
the pool words written are exactly the payload's, each once; the policy
model checks that every token read lies in the message's metadata or
window. Also pins the wrappers on CPU tensors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import selective_copy as kern
from repro_torch.kernels import testing as tt

POISON = -(1 << 40)      # no value of any token: an unloaded word
COPY_THREADS = 256       # kCopyThreads
PAD, PAYLOAD_BASE = -1, -2
KBATCH = 4               # kBatch: entries a lane loads before evaluating
POLICY_WARPS = 4         # kPolicyWarps
STAGE_BYTES = 48 * 1024  # kStageBytes


def up4(n):
    return (n + 3) // 4 * 4


# ---------------------------------------------------------------------------
# selective_copy
# ---------------------------------------------------------------------------

def copy_threads(page):
    """``page_threads((page + 3) / 4)``: a multiple of 32, 32 to 256."""
    return min(max(((page + 3) // 4 + 31) // 32 * 32, 32), COPY_THREADS)


def groups_per_pass(page):
    threads = copy_threads(page)
    per = -(-((page + 3) // 4) // threads)
    return 1 if per == 1 else (2 if per == 2 else 4)


class CopyLog:
    """The pool words a launch writes, and how."""

    def __init__(self, shape):
        self.count = np.zeros(shape, np.int64)
        self.vector_stores = 0


def meta_row(stream, mlen, b, meta_max, threads):
    """Block (b, 0): meta[b, :meta_max]; the row's loads ignore mlen."""
    s = stream.shape[1]
    out = np.full(meta_max, POISON, np.int64)
    for t in range(threads):
        for i in range(t, meta_max, threads):
            v = int(stream[b, i if i < s else s - 1])
            out[i] = v if i < mlen else 0
    return out


def payload_block(stream, ks, mlen, tlen, pid, b, jj, pool, log, pool_vec,
                  threads, ng):
    """Block (b, jj + 1): page jj of row b into pool[pid]."""
    s = stream.shape[1]
    page = pool.shape[1]
    plen, rel0 = tlen - mlen, jj * page
    q = mlen + rel0
    groups = (page + 3) // 4
    dst = pool[pid]
    for first in range(0, groups, ng * threads):
        tok = np.full((ng, threads, 4), POISON, np.int64)
        key = np.zeros((ng, threads, 4), np.int64)
        ok = np.zeros((ng, threads, 4), bool)
        for g in range(ng):                       # every load, then stores
            for t in range(threads):
                l0 = 4 * (first + g * threads + t)
                for i in range(4):
                    pos = q + l0 + i
                    ok[g, t, i] = (l0 + i < page and rel0 + l0 + i < plen
                                   and 0 <= pos < s)
                    if ok[g, t, i]:
                        tok[g, t, i] = stream[b, pos]
                        if ks is not None:
                            key[g, t, i] = ks[b, pos]
        for g in range(ng):
            for t in range(threads):
                l0 = 4 * (first + g * threads + t)
                if l0 >= page:
                    continue
                v = tok[g, t] ^ key[g, t]
                if pool_vec and ok[g, t].all():
                    dst[l0:l0 + 4] = v
                    log.count[pid, l0:l0 + 4] += 1
                    log.vector_stores += 1
                else:
                    for i in range(4):
                        if ok[g, t, i]:
                            dst[l0 + i] = v[i]
                            log.count[pid, l0 + i] += 1


def selective_copy_model(stream, meta_len, total_len, pool, tables,
                         meta_max, ks=None, aligned=True):
    """The CUDA selective copy on numpy arrays: (meta, pool, log).
    ``aligned=False`` stands for a pool off a 16-byte boundary."""
    b, s = stream.shape
    p_ext, page = pool.shape
    pps = tables.shape[1]
    threads, ng = copy_threads(page), groups_per_pass(page)
    pool_vec = page % 4 == 0 and aligned
    out = pool.astype(np.int64)
    meta = np.zeros((b, meta_max), np.int64)
    log = CopyLog(pool.shape)
    for bi in range(b):
        mlen, tlen = int(meta_len[bi]), int(total_len[bi])
        meta[bi] = meta_row(stream, mlen, bi, meta_max, threads)
        for jj in range(pps):
            pid = int(tables[bi, jj])
            if pid < 0 or pid >= p_ext:
                continue
            payload_block(stream, ks, mlen, tlen, pid, bi, jj, out, log,
                          pool_vec, threads, ng)
    return meta, out, log


def payload_words(meta_len, total_len, tables, shape, s):
    """Pool words that hold a payload token after the anchor."""
    mask = np.zeros(shape, bool)
    page = shape[1]
    for bi in range(tables.shape[0]):
        for jj in range(tables.shape[1]):
            pid = int(tables[bi, jj])
            if pid < 0 or pid >= shape[0]:
                continue
            rel = jj * page + np.arange(page)
            pos = int(meta_len[bi]) + rel
            mask[pid] = ((rel < int(total_len[bi]) - int(meta_len[bi]))
                         & (pos >= 0) & (pos < s))
    return mask


def check_copy(case, meta_max, crypto, aligned):
    stream, ml, tl, pool, tables, ks = case
    args = (jnp.asarray(stream), jnp.asarray(ml), jnp.asarray(tl),
            jnp.asarray(pool), jnp.asarray(tables))
    if crypto:
        j_meta, j_pool = jref.selective_copy_crypto_ref(
            *args, jnp.asarray(ks), meta_max=meta_max)
    else:
        j_meta, j_pool = jref.selective_copy_ref(*args, meta_max=meta_max)
    meta, out, log = selective_copy_model(
        stream, ml, tl, pool, tables, meta_max, ks if crypto else None,
        aligned=aligned)
    assert np.array_equal(meta, np.asarray(j_meta))
    assert np.array_equal(out, np.asarray(j_pool))
    want = payload_words(ml, tl, tables, pool.shape, stream.shape[1])
    assert np.array_equal(log.count > 0, want)   # the payload's words only
    assert log.count.max(initial=0) <= 1          # each written once
    return log


# pages: 8 (a block of 32 threads, most of them idle), 6 (page % 4 != 0:
# word stores), 1024 (the deployment), 2048 (two groups a thread), 4100
# (four groups a thread, two passes)
EDGE_PAGES = [dict(page=8, pps=3, meta_max=8),
              dict(page=6, pps=3, meta_max=8),
              dict(page=1024, pps=2, meta_max=256),
              dict(page=2048, pps=2, meta_max=16),
              dict(page=4100, pps=2, meta_max=12)]


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["int4-stores", "word-stores"])
@pytest.mark.parametrize("crypto", [False, True], ids=["plain", "ks"])
@pytest.mark.parametrize("s_tail", [0, 1, 2, 3],
                         ids=[f"S%4={t}" for t in range(4)])
@pytest.mark.parametrize("shape", EDGE_PAGES,
                         ids=[f"page{d['page']}" for d in EDGE_PAGES])
def test_selective_copy_model_edge_rows_match_jax(shape, s_tail, crypto,
                                                  aligned):
    """meta_len % 4 in 0..3, S % 4 in 0..3, payloads ending at S or cut by
    it, -1 slots between valid ones, meta_len 0 and meta_max."""
    case = tt.selcopy_edge_case(s_tail=s_tail, **shape)
    log = check_copy(case, shape["meta_max"], crypto, aligned)
    if aligned and shape["page"] % 4 == 0:
        assert log.vector_stores > 0


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["int4-stores", "word-stores"])
@pytest.mark.parametrize("crypto", [False, True], ids=["plain", "ks"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [dict(b=5, page=8, pps=3, meta_max=5),
                                   dict(b=4, page=1024, pps=3, meta_max=256),
                                   dict(b=3, page=12, pps=4, meta_max=7)],
                         ids=["small", "deploy-page", "odd-s"])
def test_selective_copy_model_random_rows_match_jax(shape, seed, crypto,
                                                    aligned):
    case = tt.selcopy_crypto_case(np.random.default_rng(seed), **shape)
    check_copy(case, shape["meta_max"], crypto, aligned)


def test_selective_copy_model_loads_only_payload_words():
    """A payload that covers no group of a page whole (meta_len % 4 != 0,
    a short payload) stores word by word: the poison of the words it did
    not load never reaches the pool."""
    case = tt.selcopy_edge_case(page=1024, pps=2, meta_max=256)
    stream, ml, tl, pool, tables, _ks = case
    assert set(int(m) % 4 for m in ml) == {0, 1, 2, 3}
    _meta, out, log = selective_copy_model(stream, ml, tl, pool, tables,
                                           256)
    assert (out != POISON).all() and log.vector_stores > 0


# ---------------------------------------------------------------------------
# policy_match
# ---------------------------------------------------------------------------

def warp_layout(m, w, has_ks, has_payload, stage_meta, stage_pay):
    """``warp_layout`` in csrc/policy_match.cu: (meta, ks, pay, words)."""
    words, meta_o, ks_o, pay_o = 32, -1, -1, -1
    if stage_meta:
        meta_o, words = words, words + up4(m)
        if has_ks:
            ks_o, words = words, words + up4(m)
    if stage_pay and has_payload:
        pay_o, words = words, words + up4(w)
    return meta_o, ks_o, pay_o, words


def staging(m, w, has_ks, has_payload):
    """Which rows ``libra_policy_match`` stages: (meta, payload)."""
    def fits(lay):
        return POLICY_WARPS * lay[3] * 4 <= STAGE_BYTES
    meta = fits(warp_layout(m, w, has_ks, has_payload, True, False))
    pay = fits(warp_layout(m, w, has_ks, has_payload, meta, True))
    return meta, pay and has_payload


def cond_holds(off, lo, hi, mlen, m, plen, w, has_payload, meta_at, pay_at):
    """``cond_holds`` in csrc/datapath.cuh."""
    if off == PAD:
        return True
    if off >= 0:
        if off >= mlen or off >= m:
            return False
        return lo <= meta_at(off) <= hi
    if not has_payload:
        return False
    pos = PAYLOAD_BASE - off
    if pos >= plen or pos >= w:
        return False
    return lo <= pay_at(pos) <= hi


def ffs(bits):
    """``__ffs``: 1 + the index of the lowest set bit, 0 for none."""
    return (bits & -bits).bit_length()


def policy_match_model(meta, meta_len, off, lo, hi, ks=None, live=None,
                       payload=None, payload_len=None, trace=None):
    """The CUDA policy match on numpy arrays: the [B] verdicts."""
    b, m = meta.shape
    r, k = off.shape
    w = 0 if payload is None else payload.shape[1]
    has_payload = payload is not None
    off_f, lo_f, hi_f = off.reshape(-1), lo.reshape(-1), hi.reshape(-1)
    out = np.zeros(b, np.int32)
    for bi in range(b):
        mlen = int(meta_len[bi])
        plen = int(payload_len[bi]) if has_payload else 0

        def meta_at(o):
            assert 0 <= o < min(mlen, m)
            v = int(meta[bi, o])
            return v if ks is None else v ^ int(ks[bi, o])

        def pay_at(p):
            assert 0 <= p < min(plen, w)
            return int(payload[bi, p])
        best = r
        for base in range(0, r, 32):
            e1 = min(r, base + 32) * k
            flag = np.zeros(32, np.int64)
            e0 = base * k
            while True:                            # one pass at least
                ents = []
                for u in range(KBATCH):
                    for lane in range(32):
                        e = e0 + 32 * u + lane
                        ents.append((e, lane) if e < e1 else (None, lane))
                if e0 == base * k:
                    for lane in range(32):
                        rule = base + lane
                        alive = rule < r and (live is None or live[rule] > 0)
                        flag[lane] = 0 if alive else 1
                for e, lane in ents:
                    if e is None:
                        continue
                    if trace is not None:
                        trace.append((base, e, lane))
                    if not cond_holds(int(off_f[e]), int(lo_f[e]),
                                      int(hi_f[e]), mlen, m, plen, w,
                                      has_payload, meta_at, pay_at):
                        assert 0 <= e // k - base < 32
                        flag[e // k - base] = 1
                e0 += 32 * KBATCH
                if e0 >= e1:
                    break
            hold = sum(1 << lane for lane in range(32) if flag[lane] == 0)
            if hold:
                best = base + ffs(hold) - 1
                break
        out[bi] = best
    return out


POLICY_CASES = {
    "deploy": lambda rng: tt.policy_payload_case(rng, b=8, meta_max=256,
                                                 r=3, k=1, w=1024),
    "wide": lambda rng: tt.policy_payload_case(rng, b=9, meta_max=40, r=70,
                                               k=40, w=16),
    "small": lambda rng: tt.policy_payload_case(rng, b=6, meta_max=12, r=7,
                                                k=3, w=8),
    "one-round": lambda rng: tt.policy_payload_case(rng, b=8, meta_max=16,
                                                    r=8, k=4, w=8),
    "r33-k33": lambda rng: tt.policy_edge_case(rng, b=12, meta_max=24, r=33,
                                               k=33, w=16),
    "r33-last": lambda rng: tt.policy_edge_case(rng, b=12, meta_max=24,
                                                r=33, k=1, w=16,
                                                fail_first=32),
    "k33": lambda rng: tt.policy_edge_case(rng, b=12, meta_max=24, r=4,
                                           k=33, w=16),
    "payload-edges": lambda rng: tt.policy_edge_case(rng, b=10, meta_max=12,
                                                     r=6, k=2, w=8),
    "odd-m": lambda rng: tt.policy_payload_case(rng, b=7, meta_max=13, r=7,
                                                k=3, w=9),
    "unstaged-window": lambda rng: tt.policy_payload_case(
        rng, b=3, meta_max=64, r=5, k=3, w=16384),
    "unstaged-meta": lambda rng: tt.policy_payload_case(
        rng, b=3, meta_max=3101, r=5, k=3, w=8),
}
OPERANDS = {"plain": (), "ks": ("ks",), "live": ("live",),
            "payload": ("payload",), "ks+live": ("ks", "live"),
            "ks+payload": ("ks", "payload"),
            "live+payload": ("live", "payload"),
            "all": ("ks", "live", "payload")}


def _policy_operands(name, opts, seed=5):
    rng = np.random.default_rng(seed)
    meta, ml, off, lo, hi, ks, pw, pln = POLICY_CASES[name](rng)
    ml = ml.copy()
    ml[0] = 0                                      # an empty metadata row
    r = off.shape[0]
    kw = dict(ks=ks if "ks" in opts else None,
              live=tt.policy_live_column(rng, r) if "live" in opts else None)
    if "payload" in opts:
        kw.update(payload=pw, payload_len=pln)
    return (meta, ml, off, lo, hi), kw


def _jax_policy(args, kw):
    j = {k: (None if v is None else jnp.asarray(v)) for k, v in kw.items()}
    return np.asarray(jref.policy_match_ref(
        *(jnp.asarray(a) for a in args), j.get("ks"), j.get("live"),
        payload=j.get("payload"), payload_len=j.get("payload_len")))


@pytest.mark.parametrize("opts", list(OPERANDS.values()),
                         ids=list(OPERANDS))
@pytest.mark.parametrize("name", list(POLICY_CASES))
def test_policy_match_model_matches_jax(name, opts):
    args, kw = _policy_operands(name, opts)
    got = policy_match_model(*args, **kw)
    assert np.array_equal(got, _jax_policy(args, kw))


def test_policy_match_model_takes_the_second_chunk():
    """R = 33 with the first 32 rules failing: the match is rule 32, the
    first bit of the second chunk's ballot."""
    args, kw = _policy_operands("r33-last", ("payload",))
    got = policy_match_model(*args, **kw)
    assert (got == 32).any() and set(got.tolist()) <= {32, 33}
    assert np.array_equal(got, _jax_policy(args, kw))


def test_policy_match_model_lane_mapping():
    """Lane i takes the flattened entries i, i + 32, ... of its chunk:
    every entry of a chunk exactly once, by lane e % 32, chunk by chunk."""
    args, kw = _policy_operands("wide", ())
    meta, ml, off, lo, hi = args
    lo = np.zeros_like(lo)            # every condition on a present token
    hi = np.full_like(hi, 1 << 30)    # holds: no early first match
    off = np.where(off >= 0, 0, -1).astype(np.int32)
    ml = np.full_like(ml, 5)
    trace = []
    got = policy_match_model(meta[:1], ml[:1], off, lo, hi, trace=trace)
    assert got[0] == 0                # rule 0 holds: one chunk is walked
    r, k = off.shape
    seen = [e for base, e, lane in trace]
    assert sorted(seen) == list(range(32 * k))
    assert all(e % 32 == lane and e // k // 32 == base // 32
               for base, e, lane in trace)


@pytest.mark.parametrize("r,k", [(0, 3), (5, 0), (0, 0)])
def test_policy_match_model_empty_tables(r, k):
    """R == 0 answers 0 (= R) for every row, as the port's plain version
    does (the jnp oracle raises); K == 0 makes every live rule hold."""
    rng = np.random.default_rng(3)
    meta = rng.integers(0, 200, (4, 8)).astype(np.int32)
    ml = np.array([0, 3, 8, 5], np.int32)
    off = np.zeros((r, k), np.int32)
    live = tt.policy_live_column(rng, r) if r else None
    got = policy_match_model(meta, ml, off, off, off, live=live)
    want = tref.policy_match_ref(*(torch.from_numpy(a) for a in
                                   (meta, ml, off, off, off)),
                                 live=None if live is None
                                 else torch.from_numpy(live))
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("name,meta_staged,window_staged", [
    ("deploy", True, True), ("wide", True, True),
    ("unstaged-window", True, False), ("unstaged-meta", False, True)])
def test_policy_match_staging_of_the_chip_cases(name, meta_staged,
                                                window_staged):
    """The shared-memory budget stages both rows at the deployment's shape
    (M = 256 with a keystream, W = 1024: 25 KB a block), and the
    ``unstaged-*`` cases of chip_smoke's phase 1 take the other paths."""
    (meta, *_), kw = _policy_operands(name, ("ks", "payload"))
    got = staging(meta.shape[1], kw["payload"].shape[1], True, True)
    assert got == (meta_staged, window_staged)


# ---------------------------------------------------------------------------
# the wrappers on CPU tensors
# ---------------------------------------------------------------------------

def test_rx_wrappers_refuse_cpu_tensors_and_count_nothing():
    kern.reset_launches()
    c = tt.to_torch(tt.selcopy_edge_case(page=8, pps=3, meta_max=8))
    stream, ml, tl, pool, tables, ks = c
    with pytest.raises(ValueError, match="CUDA tensor"):
        kern.selective_copy(stream, ml, tl, pool, tables, meta_max=8,
                            keystream=ks)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.selective_copy(stream, ml, tl, pool, tables, meta_max=8,
                           impl="cuda")
    p = tt.to_torch(tt.policy_edge_case(np.random.default_rng(0)))
    meta, pml, off, lo, hi, pks, pw, pln = p
    with pytest.raises(ValueError, match="CUDA tensor"):
        kern.policy_match(meta, pml, off, lo, hi, keystream=pks, payload=pw,
                          payload_len=pln)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.policy_match(meta, pml, off, lo, hi, impl="cuda")
    assert kern.LAUNCHES["selective_copy"] == 0
    assert kern.LAUNCHES["policy_match"] == 0


@pytest.mark.parametrize("crypto", [False, True], ids=["plain", "ks"])
def test_rx_auto_on_cpu_takes_the_plain_version(crypto):
    kern.reset_launches()
    case = tt.selcopy_edge_case(page=6, pps=3, meta_max=8, s_tail=1)
    stream, ml, tl, pool, tables, ks = case
    meta, out, _log = selective_copy_model(stream, ml, tl, pool, tables, 8,
                                           ks if crypto else None)
    c = tt.to_torch(case)
    ptr = c[3].data_ptr()
    got_meta, got_pool = ops.selective_copy(
        c[0], c[1], c[2], c[3], c[4], meta_max=8, impl="auto",
        keystream=c[5] if crypto else None)
    assert got_pool is c[3] and got_pool.data_ptr() == ptr
    assert np.array_equal(got_meta.numpy(), meta)
    assert np.array_equal(got_pool.numpy(), out)
    args, kw = _policy_operands("payload-edges", ("ks", "live", "payload"))
    want = policy_match_model(*args, **kw)
    t = {k: (None if v is None else torch.from_numpy(v))
         for k, v in kw.items()}
    got = ops.policy_match(*(torch.from_numpy(a) for a in args),
                           impl="auto", keystream=t["ks"], live=t["live"],
                           payload=t["payload"],
                           payload_len=t["payload_len"])
    assert np.array_equal(got.numpy(), want)
    assert all(n == 0 for n in kern.LAUNCHES.values())
