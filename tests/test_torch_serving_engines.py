"""The port's four serving engines against the JAX package's, on the CPU.

Weights of the reduced ``libra-proxy-125m`` (and, for the model-level
tests, the reduced ``phi4-mini-3.8b``, GQA 4/2) are made by the JAX
package from a seed and carried across with ``params_from_jax``; the same
numpy-seeded prompts go through ``repro`` and ``repro_torch``. Each test of
``tests/test_serving.py`` and ``tests/test_engine_properties.py`` has a twin
here (``*_twin``), and every engine -- ``LibraEngine``, ``StandardEngine``,
``CopierEngine``, ``StaticEngine`` (``device="cpu"``) -- must give the JAX
engine's tokens, ``EngineStats`` and ``CopyCounters`` exactly, its KV pool
or contiguous cache to ``atol = rtol = 1e-4`` (float32). Also
``prefill_dense`` / ``decode_step_dense`` and the copy the undonated step
makes, ``LibraEngine``'s ``stack`` / ``kv_pool`` / ``pool_pages`` options
with two engines on one stack, ``PagedKVPool``'s explicit geometry, the
no-silent-CPU rule and ``examples/disaggregated_handoff_torch.py``."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.core import LibraStack as JStack
from repro.core.parser import TokenStreamParser as JParser
from repro.models.registry import build_model as j_build
from repro.serving import engine as jengine
from repro.serving.kv_cache import PagedKVPool as JKVPool
from repro_torch.core import LibraStack as TStack
from repro_torch.core.parser import TokenStreamParser as TParser
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model as t_build
from repro_torch.serving import engine as tengine
from repro_torch.serving.kv_cache import PagedKVPool as TKVPool

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "libra-proxy-125m"
PAGE = 8
NAMES = ("libra", "standard", "copier", "static")
CLASSES = {"libra": "LibraEngine", "standard": "StandardEngine",
           "copier": "CopierEngine", "static": "StaticEngine"}


def _carry(arch):
    cfg = jconfigs.get_reduced(arch)
    jm = j_build(cfg, page_size=PAGE)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = t_build(tconfigs.get_reduced(arch), page_size=PAGE)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm, device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def mp():
    """(JAX model, JAX params, port model, port params) of the reduced
    libra-proxy-125m, the port's weights carried across from JAX's."""
    return _carry(ARCH)


@pytest.fixture(scope="module", params=["phi4-mini-3.8b", ARCH])
def model_twin(request):
    return _carry(request.param)


def _close(jax_out, torch_out):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out), **TOL)


def _slot_bytes(cfg, max_len: int) -> int:
    """One StaticEngine slot: the memory_budget that buys one request."""
    return cfg.num_layers * max_len * 2 * cfg.num_kv_heads * cfg.head_dim * 4


def _pair(mp, name, header_len=None, **kw):
    """The JAX engine ``name`` and the port's, built alike."""
    jm, jp, tm, tp = mp
    jkw, tkw = dict(kw), dict(kw, device="cpu")
    if header_len is not None:
        jkw["parser"] = JParser(header_len=header_len)
        tkw["parser"] = TParser(header_len=header_len)
    return (getattr(jengine, CLASSES[name])(jm, jp, **jkw),
            getattr(tengine, CLASSES[name])(tm, tp, **tkw))


def _engine_kw(name, max_batch, max_len=64):
    if name == "static":
        cfg = tconfigs.get_reduced(ARCH)
        return dict(memory_budget=max_batch * _slot_bytes(cfg, max_len),
                    max_len=max_len)
    kw = dict(max_batch=max_batch, max_len=max_len)
    if name == "libra":
        kw["page_size"] = PAGE
    return kw


def _assert_same(j, t, j_reqs, t_reqs):
    """Tokens, ``EngineStats`` and ``CopyCounters`` exactly; the KV pool or
    the contiguous cache to float32 tolerance."""
    assert [r.output for r in t_reqs] == [r.output for r in j_reqs]
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    if isinstance(j, jengine.LibraEngine):
        assert dataclasses.asdict(t.stack.counters) == \
            dataclasses.asdict(j.stack.counters)
        _close(j.pool.pool, t.pool.pool)
    else:
        assert t.max_batch == j.max_batch
        _close(j.cache, t.cache)


def _serve(engs, prompts, gen):
    reqs = [[e.submit(p, max_new_tokens=gen) for p in prompts] for e in engs]
    for e in engs:
        e.run()
    return reqs


def _mk_requests(rng, n, lo=6, hi=20):
    return [rng.integers(1, 250, rng.integers(lo, hi)) for _ in range(n)]


def _reference_generate(model, params, prompt, n_new):
    """The JAX test's naive reference: a full forward of the JAX model over
    the whole context per token (the port has no ``forward``)."""
    toks = list(map(int, prompt))
    out = []
    for _ in range(n_new):
        hidden, _ = model.forward(params, jnp.array([toks], jnp.int32),
                                  remat="none", compute_dtype=jnp.float32)
        logits = model.logits(params, hidden[:, -1:], jnp.float32)
        nxt = int(jnp.argmax(logits[0, 0]))
        out.append(nxt)
        toks.append(nxt)
    return out


# ---------------------------------------------------------------------------
# TransformerLM.prefill_dense / decode_step_dense
# ---------------------------------------------------------------------------

def _dense_inputs(cfg, lens, rng):
    s = max(8, max(lens))
    prompts = [rng.integers(1, cfg.vocab_size - 1, n) for n in lens]
    tokens = np.stack([np.pad(p, (0, s - len(p))) for p in prompts]
                      ).astype(np.int32)
    return tokens, np.array(lens, np.int32)


def test_prefill_and_decode_dense_match_jax(model_twin):
    """Prompts of 5 and 13 tokens (padded to 13) into a 24-token cache:
    the first tokens, the zero-padded cache, then four decode steps' full
    logits and caches, the last step at the cache's end."""
    jm, jp, tm, tp = model_twin
    rng = np.random.default_rng(11)
    tokens, seq_lens = _dense_inputs(tm.cfg, [5, 13], rng)
    max_len = 24
    j_first, j_kv = jax.jit(lambda p, t, s: jm.prefill_dense(
        p, t, s, max_len, compute_dtype=jnp.float32))(jp, tokens, seq_lens)
    t_first, t_kv = tm.prefill_dense(tp, torch.from_numpy(tokens),
                                     torch.from_numpy(seq_lens), max_len)
    assert t_first.dtype == torch.int32
    assert t_first.tolist() == np.asarray(j_first).tolist()
    assert tuple(t_kv.shape) == tuple(j_kv.shape)
    _close(j_kv, t_kv)
    assert not t_kv[:, :, tokens.shape[1]:].any()

    j_dec = jax.jit(lambda p, t, s, c: jm.decode_step_dense(
        p, t, s, c, compute_dtype=jnp.float32))
    j_cache, t_cache = j_kv, t_kv
    cur = np.asarray(j_first).astype(np.int32)
    for pos in ([5, 13], [6, 14], [7, 22], [8, 23]):
        pos = np.array(pos, np.int32)
        j_logits, j_cache = j_dec(jp, cur, pos, j_cache)
        t_logits, t_cache = tm.decode_step_dense(
            tp, torch.from_numpy(cur), torch.from_numpy(pos), t_cache)
        assert t_logits.dtype == torch.float32
        assert tuple(t_logits.shape) == (2, tm.cfg.vocab_size)
        _close(j_logits, t_logits)
        _close(j_cache, t_cache)
        assert t_logits.argmax(-1).tolist() == \
            np.asarray(j_logits).argmax(-1).tolist()
        cur = np.asarray(j_logits).argmax(-1).astype(np.int32)


def test_decode_logits_round_the_head_like_jax(model_twin):
    """Both packages' decode steps take logits over bfloat16-rounded head
    weights (the JAX ones call ``logits`` without ``compute_dtype``): the
    port's rounded logits hold the JAX logits to 1e-5, the float32 ones
    do not."""
    jm, jp, tm, tp = model_twin
    h = np.random.default_rng(14).standard_normal(
        (512, tm.cfg.d_model)).astype(np.float32)
    want = np.asarray(jm.logits(jp, h[:, None]))[:, 0]
    got = tm.logits(tp, torch.from_numpy(h), weight_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert np.abs(tm.logits(tp, torch.from_numpy(h)).numpy() - want
                  ).max() > 1e-4


def test_decode_step_dense_clamps_a_write_past_the_cache_end(mp):
    """``dynamic_update_slice`` clamps its start so the update fits: a
    position at or past ``Smax`` writes the last row, as in JAX."""
    jm, jp, tm, tp = mp
    rng = np.random.default_rng(12)
    cache = rng.standard_normal((tm.cfg.num_layers, 2, 16, 2,
                                 tm.cfg.num_kv_heads, tm.cfg.head_dim)
                                ).astype(np.float32)
    tokens = np.array([3, 4], np.int32)
    pos = np.array([16, 20], np.int32)
    j_logits, j_cache = jm.decode_step_dense(jp, tokens, pos, cache,
                                             compute_dtype=jnp.float32)
    t_logits, t_cache = tm.decode_step_dense(
        tp, torch.from_numpy(tokens), torch.from_numpy(pos),
        torch.from_numpy(cache))
    _close(j_logits, t_logits)
    _close(j_cache, t_cache)


@pytest.mark.parametrize("donate", [False, True])
def test_decode_step_dense_copies_unless_donated(mp, donate):
    """Undonated, the step returns a new cache (the copy tax) and leaves
    its input as it was; donated, it writes the input in place."""
    _jm, _jp, tm, tp = mp
    c = tm.cfg
    cache = torch.zeros((c.num_layers, 2, 16, 2, c.num_kv_heads, c.head_dim))
    ptr = cache.data_ptr()
    _logits, out = tm.decode_step_dense(
        tp, torch.tensor([3, 4], dtype=torch.int32),
        torch.tensor([0, 5], dtype=torch.int32), cache, donate=donate)
    assert out[:, 1, 5].any() and not out[:, 1, 6:].any()
    if donate:
        assert out is cache and out.data_ptr() == ptr
    else:
        assert out.data_ptr() != ptr
        assert out.untyped_storage().data_ptr() != \
            cache.untyped_storage().data_ptr()
        assert not cache.any()


@pytest.mark.parametrize("name", ["standard", "copier", "static"])
def test_baseline_cache_storage_per_step(mp, name):
    """The engine's cache is a new tensor after every undonated step and
    the same one under ``StaticEngine``."""
    _j, t = _pair(mp, name, **_engine_kw(name, 2))
    rng = np.random.default_rng(13)
    for p in _mk_requests(rng, 2):
        t.submit(p, max_new_tokens=4)
    ptrs = [t.cache.data_ptr()]
    while t.waiting or t.active:
        t.step()
        ptrs.append(t.cache.data_ptr())
    assert t.stats.steps == 3
    if name == "static":
        assert len(set(ptrs)) == 1
    else:
        assert all(a != b for a, b in zip(ptrs[1:], ptrs[2:]))


# ---------------------------------------------------------------------------
# every engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_req,max_batch,gen", [(3, 3, 5), (5, 2, 3),
                                                 (2, 2, 1)])
@pytest.mark.parametrize("name", NAMES)
def test_engine_matches_jax(mp, name, n_req, max_batch, gen):
    """Waves of admission (more requests than slots), idle slots, and
    requests that complete at prefill."""
    rng = np.random.default_rng(n_req)
    prompts = _mk_requests(rng, n_req)
    j, t = _pair(mp, name, header_len=4, **_engine_kw(name, max_batch))
    j_reqs, t_reqs = _serve((j, t), prompts, gen)
    _assert_same(j, t, j_reqs, t_reqs)
    assert all(len(r.output) == gen for r in t_reqs)
    if name == "libra":
        assert t.pool.alloc.free_pages == t.pool.alloc.total_pages - 1
        assert len(t.pool.registry) == 0
    else:
        assert sorted(t.slot_free) == list(range(max_batch))


# ---------------------------------------------------------------------------
# twins of tests/test_serving.py
# ---------------------------------------------------------------------------

def test_libra_matches_reference_twin(mp):
    """Twin of ``test_libra_matches_reference``: the port's engine against
    the JAX engine (tokens, stats, counters, pool) and against the JAX
    test's reference, the JAX model's full forward per token (the port has
    no ``forward``)."""
    jm, jp, _tm, _tp = mp
    rng = np.random.default_rng(0)
    prompts = _mk_requests(rng, 3)
    j, t = _pair(mp, "libra", header_len=4, max_batch=3, max_len=64,
                 page_size=8)
    j_reqs, t_reqs = _serve((j, t), prompts, 5)
    _assert_same(j, t, j_reqs, t_reqs)
    for r, p in zip(t_reqs, prompts):
        assert r.output == _reference_generate(jm, jp, p, 5)


def test_all_engines_agree_twin(mp):
    """Twin of ``test_all_engines_agree``: each port engine equals its JAX
    engine, and all four give the Libra engine's tokens."""
    rng = np.random.default_rng(1)
    prompts = _mk_requests(rng, 4)
    outs = {}
    for name, kw in [("libra", dict(max_batch=4, max_len=64, page_size=8)),
                     ("standard", dict(max_batch=4, max_len=64)),
                     ("copier", dict(max_batch=4, max_len=64)),
                     ("static", dict(memory_budget=1 << 30, max_len=64))]:
        j, t = _pair(mp, name, **kw)
        j_reqs, t_reqs = _serve((j, t), prompts, 4)
        _assert_same(j, t, j_reqs, t_reqs)
        outs[name] = [r.output for r in t_reqs]
    for name, o in outs.items():
        assert o == outs["libra"], (name, o, outs["libra"])


def test_selective_copy_traffic_advantage_twin(mp):
    """Twin of ``test_selective_copy_traffic_advantage``: the JAX test's
    relations on the port, and both engines' stats equal to JAX's."""
    rng = np.random.default_rng(2)
    prompts = _mk_requests(rng, 4)
    jl, libra = _pair(mp, "libra", max_batch=4, max_len=64, page_size=8)
    js, std = _pair(mp, "standard", max_batch=4, max_len=64)
    for j, t in ((jl, libra), (js, std)):
        j_reqs, t_reqs = _serve((j, t), prompts, 6)
        _assert_same(j, t, j_reqs, t_reqs)
    assert libra.stats.d2h_bytes * 50 < std.stats.d2h_bytes
    assert libra.stats.payload_copy_bytes == 0
    assert std.stats.payload_copy_bytes > std.stats.steps * 1000
    assert libra.pool.alloc.free_pages == libra.pool.alloc.total_pages - 1


def test_continuous_batching_admission_twin(mp):
    """Twin of ``test_continuous_batching_admission``: 7 requests through
    2 slots; the port's engine against the JAX engine and the JAX test's
    full-forward reference (the port has no ``forward``)."""
    jm, jp, _tm, _tp = mp
    rng = np.random.default_rng(3)
    prompts = _mk_requests(rng, 7)
    j, t = _pair(mp, "libra", max_batch=2, max_len=64, page_size=8)
    j_reqs, t_reqs = _serve((j, t), prompts, 3)
    _assert_same(j, t, j_reqs, t_reqs)
    assert len(t.completed) == 7
    for r, p in zip(t_reqs, prompts):
        assert r.output == _reference_generate(jm, jp, p, 3)


def test_vpi_forwarding_zero_copy_twin(mp):
    """Twin of ``test_vpi_forwarding_zero_copy``: a shared handle moves no
    payload and keeps its pages after release, in both packages alike."""
    rng = np.random.default_rng(4)
    first, second = rng.integers(1, 250, 12), rng.integers(1, 250, 12)
    engs = _pair(mp, "libra", max_batch=2, max_len=64, page_size=8)
    seen = []
    for eng in engs:
        eng.submit(first, max_new_tokens=3)
        eng.run()
        r2 = eng.submit(second, max_new_tokens=5)
        eng.step()
        h2 = eng.forward_handle(r2)
        assert eng.stats.zero_copy_bytes > 0
        before = eng.pool.alloc.free_pages
        eng.pool.release(h2)
        assert eng.pool.alloc.free_pages == before
        eng.run()
        seen.append((before, [r.output for r in eng.completed]))
    assert seen[0] == seen[1]
    j, t = engs
    _assert_same(j, t, j.completed, t.completed)


# ---------------------------------------------------------------------------
# twins of tests/test_engine_properties.py
# ---------------------------------------------------------------------------

def test_engine_invariants_random_workloads_twin(mp):
    """Twin of ``test_engine_invariants_random_workloads``: each drawn
    request mix goes through both packages' engines, which must agree, and
    the JAX test's invariants hold on the port."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    cfg = tconfigs.get_reduced(ARCH)

    @settings(max_examples=8, deadline=None)
    @given(st.data())
    def check(data):
        rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 16)))
        n_req = data.draw(st.integers(1, 6))
        max_batch = data.draw(st.integers(1, 4))
        j, t = _pair(mp, "libra", header_len=2, max_batch=max_batch,
                     max_len=64, page_size=8)
        prompts, gens = [], []
        for _ in range(n_req):
            plen = data.draw(st.integers(3, 30))
            gens.append(data.draw(st.integers(1, 6)))
            prompts.append(rng.integers(1, cfg.vocab_size - 1, plen))
        reqs = [[e.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
                for e in (j, t)]
        for e in (j, t):
            e.run(max_steps=500)
        _assert_same(j, t, *reqs)
        assert len(t.completed) == n_req
        for r, gen in zip(reqs[1], gens):
            assert len(r.output) == gen
            assert all(0 <= x < cfg.vocab_size for x in r.output)
        assert t.pool.alloc.free_pages == t.pool.alloc.total_pages - 1
        assert len(t.pool.registry) == 0
        steps = t.stats.steps + t.stats.prefills
        assert t.stats.d2h_bytes <= 4 * t.max_batch * max(steps, 1)

    check()


def test_pool_pressure_admission_twin(mp):
    """Twin of ``test_pool_pressure_admission``: a 14-page pool (about two
    requests' worth) makes requests wait; all are served, alike in both."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 250, 24) for _ in range(5)]
    j, t = _pair(mp, "libra", max_batch=4, max_len=64, page_size=8,
                 pool_pages=14)
    assert t.pool.alloc.total_pages == 14
    reqs = [[e.submit(p, max_new_tokens=3) for p in prompts] for e in (j, t)]
    for e in (j, t):
        e.run(max_steps=300)
    _assert_same(j, t, *reqs)
    assert len(t.completed) == 5
    assert t.pool.alloc.free_pages == t.pool.alloc.total_pages - 1


# ---------------------------------------------------------------------------
# LibraEngine's shared stack, PagedKVPool's geometry, the device rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2])
def test_two_engines_on_one_shared_stack_match_jax(mp, n_shards):
    """Two engines on one ``LibraStack`` and one KV pool, stepped in turns:
    each engine's tokens and stats and the shared counters and pool equal
    the JAX pair's. With two shards the one device plays shard 0, as the
    JAX package's one-device mesh does: shard 1's pages are neither written
    nor read."""
    jm, jp, tm, tp = mp
    rng = np.random.default_rng(20 + n_shards)
    prompts = _mk_requests(rng, 6)
    kw = dict(max_batch=2, max_len=64, page_size=8)
    pairs = []
    for build, stack_cls, m, p, extra in (
            (jengine.LibraEngine, JStack, jm, jp, {}),
            (tengine.LibraEngine, TStack, tm, tp, dict(device="cpu"))):
        stack = stack_cls(n_shards=n_shards, pages_per_shard=48,
                          page_size=8, **extra)
        a = build(m, p, stack=stack, **kw, **extra)
        b = build(m, p, stack=stack, kv_pool=a.pool, **kw, **extra)
        assert b.pool is a.pool and a.stack is b.stack
        # the port's pool keeps the stack's registry; the JAX pool swaps
        # the (empty, so falsy) registry for a new one
        assert (a.pool.registry is stack.registry) == (build is
                                                        tengine.LibraEngine)
        reqs = [a.submit(q, max_new_tokens=4) for q in prompts[:3]] + \
            [b.submit(q, max_new_tokens=4) for q in prompts[3:]]
        while any(e.waiting or e.active for e in (a, b)):
            a.step()
            b.step()
        pairs.append((a, b, reqs))
    (ja, jb, j_reqs), (ta, tb, t_reqs) = pairs
    assert [r.output for r in t_reqs] == [r.output for r in j_reqs]
    for j, t in ((ja, ta), (jb, tb)):
        assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    assert dataclasses.asdict(ta.stack.counters) == \
        dataclasses.asdict(ja.stack.counters)
    _close(ja.pool.pool, ta.pool.pool)
    alloc = ta.pool.alloc
    assert alloc.free_pages == alloc.total_pages - 2    # two parking pages
    assert len(ta.pool.registry) == 0


@pytest.mark.parametrize("case", ["pool_pages", "page_size", "kv_pool"])
def test_shared_stack_options_are_checked(mp, case):
    """``pool_pages`` with an external stack, a stack of another page size
    and a ``kv_pool`` on another allocator raise ``ValueError`` (the JAX
    engine raises or asserts on each)."""
    _jm, _jp, tm, tp = mp
    stack = TStack(n_shards=1, pages_per_shard=32, page_size=8, device="cpu")
    kw = dict(max_batch=2, max_len=32, page_size=8, stack=stack,
              device="cpu")
    if case == "pool_pages":
        kw["pool_pages"] = 14
        match = "pool_pages"
    elif case == "page_size":
        kw["stack"] = TStack(n_shards=1, pages_per_shard=32, page_size=16,
                             device="cpu")
        match = "stack's pages"
    else:
        kw["kv_pool"] = TKVPool(tm, n_shards=1, pages_per_shard=32,
                                page_size=8, device="cpu")
        match = "allocator"
    with pytest.raises(ValueError, match=match):
        tengine.LibraEngine(tm, tp, **kw)


def test_paged_kv_pool_explicit_geometry_matches_jax(mp):
    """``PagedKVPool(n_shards=, pages_per_shard=, max_pages_per_seq=)``
    builds its own allocator and registry, as in JAX; both geometries at
    once raise."""
    jm, _jp, tm, _tp = mp
    geo = dict(n_shards=2, pages_per_shard=12, page_size=8,
               max_pages_per_seq=5)
    j, t = JKVPool(jm, **geo), TKVPool(tm, device="cpu", **geo)
    assert tuple(t.pool.shape) == tuple(j.pool.shape)
    assert t.pool.dtype == torch.float32 and not t.pool.any()
    for key in ("n_shards", "pages_per_shard", "page_size",
                "max_pages_per_seq", "total_pages", "free_pages"):
        assert getattr(t.alloc, key) == getattr(j.alloc, key), key
    assert len(t.registry) == len(j.registry) == 0
    hs = [pool.anchor_sequence(30, 4, reserve=6) for pool in (j, t)]
    assert [(p.shard, p.local_pid, p.base_pos) for p in hs[1].pages] == \
        [(p.shard, p.local_pid, p.base_pos) for p in hs[0].pages]
    with pytest.raises(Exception):
        j.anchor_sequence(41, 4)               # more than 5 pages
    with pytest.raises(Exception):
        t.anchor_sequence(41, 4)
    with pytest.raises(ValueError, match="not both"):
        TKVPool(tm, n_shards=1, pages_per_shard=4, alloc=t.alloc,
                device="cpu")


@pytest.mark.parametrize("name", ["standard", "copier", "static"])
def test_baseline_on_cuda_without_gpu_raises(mp, name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU rule cannot be exercised")
    _jm, _jp, tm, tp = mp
    kw = _engine_kw(name, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tengine, CLASSES[name])(tm, tp, **kw)


def test_handoff_example_is_bit_identical():
    """``examples/disaggregated_handoff_torch.py --device cpu`` in its own
    process: decode on the second engine equals the monolithic engine."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [
        str(ROOT / "src"), os.environ.get("PYTHONPATH")])))
    res = subprocess.run([sys.executable,
                          str(ROOT / "examples/disaggregated_handoff_torch.py"),
                          "--device", "cpu"], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    lines = res.stdout.splitlines()
    assert lines[0] == ("handoff verified: outputs bit-identical to "
                        "monolithic serving")
    assert lines[1].startswith("KV anchored: ") and \
        lines[2].startswith("zero-copy forwarded: ")
