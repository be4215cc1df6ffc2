"""The port's plain PyTorch datapath kernels against the JAX package's jnp
oracles: the same numpy-seeded inputs go through ``repro.kernels.ref``
and ``repro_torch.kernels.ref`` and must come out bit-identical (int32),
across the optional-operand matrix and the edge rows (``meta_len == 0``,
``payload_len == 0``, an all ``-1`` table row). Also pins the ``impl``
dispatch (no CPU fallback for the CUDA path, TPU modes refused), the
in-place pool update, and the C interface the wrappers bind to."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import selective_copy as kern
from repro_torch.kernels import testing as tt

SHAPES = [dict(b=2, page=8, pps=4, meta_max=16),
          dict(b=3, page=4, pps=2, meta_max=8),
          dict(b=5, page=8, pps=3, meta_max=5)]
SEEDS = [0, 1, 2]


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(
        np.ascontiguousarray(a, np.int32))


def _same(jax_out, torch_out):
    assert torch_out.dtype == torch.int32
    j = np.asarray(jax_out)
    assert j.dtype == np.int32
    assert np.array_equal(j, torch_out.numpy())


def _selcopy_cases():
    cases = []
    for shape in SHAPES:
        for seed in SEEDS:
            cases.append(pytest.param(
                tt.selcopy_crypto_case(np.random.default_rng(seed), **shape),
                shape["meta_max"], id=f"b{shape['b']}p{shape['page']}-s{seed}"))
    cases.append(pytest.param(tt.edge_rows_case(), 8, id="edge-rows"))
    return cases


@pytest.mark.parametrize("crypto", [False, True], ids=["plain", "ks"])
@pytest.mark.parametrize("case,meta_max", _selcopy_cases())
def test_selective_copy_matches_jax(case, meta_max, crypto):
    stream, ml, tl, pool, tables, ks = case
    args = (stream, ml, tl, pool, tables)
    if crypto:
        j_meta, j_pool = jref.selective_copy_crypto_ref(
            *map(_j, args), _j(ks), meta_max=meta_max)
        t_pool = _t(pool)
        t_meta, out_pool = tref.selective_copy_crypto_ref(
            *map(_t, args[:3]), t_pool, _t(tables), _t(ks), meta_max=meta_max)
    else:
        j_meta, j_pool = jref.selective_copy_ref(*map(_j, args),
                                                 meta_max=meta_max)
        t_pool = _t(pool)
        t_meta, out_pool = tref.selective_copy_ref(
            *map(_t, args[:3]), t_pool, _t(tables), meta_max=meta_max)
    assert out_pool is t_pool                  # anchored in place
    _same(j_meta, t_meta)
    _same(j_pool, t_pool)


def _gather_cases():
    cases = []
    for shape in SHAPES:
        kw = dict(b=shape["b"], page=shape["page"], pps=shape["pps"])
        for seed in SEEDS:
            cases.append(pytest.param(
                tt.selgather_case(np.random.default_rng(seed), **kw),
                id=f"b{kw['b']}p{kw['page']}-s{seed}"))
    stream, ml, tl, pool, tables, ks = tt.edge_rows_case()
    cases.append(pytest.param(
        (pool, tables, (tl - ml).astype(np.int32),
         np.random.default_rng(5).integers(0, 1 << 31, (3, 24))
         .astype(np.int32)), id="edge-rows"))
    return cases


@pytest.mark.parametrize("crypto", [False, True], ids=["plain", "ks"])
@pytest.mark.parametrize("case", _gather_cases())
def test_selective_gather_matches_jax(case, crypto):
    pool, tables, lengths, ks = case
    ks = ks if crypto else None
    _same(jref.selective_gather_ref(_j(pool), _j(tables), _j(lengths),
                                    _j(ks)),
          tref.selective_gather_ref(_t(pool), _t(tables), _t(lengths),
                                    _t(ks)))


POLICY_VARIANTS = {
    "plain": dict(),
    "ks": dict(ks=True),
    "live": dict(live=True),
    "payload": dict(payload=True),
    "all": dict(ks=True, live=True, payload=True),
}


@pytest.mark.parametrize("variant", list(POLICY_VARIANTS))
@pytest.mark.parametrize("seed", SEEDS)
def test_policy_match_matches_jax(seed, variant):
    opt = POLICY_VARIANTS[variant]
    rng = np.random.default_rng(seed)
    meta, ml, off, lo, hi, ks, pw, pln = tt.policy_payload_case(
        rng, b=6, meta_max=12, r=7, k=3, w=8)
    if seed == 0:
        ml = ml.copy()
        ml[0] = 0                                  # empty metadata row
        pln = pln.copy()
        pln[1] = 0                                 # empty payload row
    live = tt.policy_live_column(rng, 7) if opt.get("live") else None
    ks = ks if opt.get("ks") else None
    if not opt.get("payload"):
        pw = pln = None
    j = jref.policy_match_ref(_j(meta), _j(ml), _j(off), _j(lo), _j(hi),
                              _j(ks), _j(live), payload=_j(pw),
                              payload_len=_j(pln))
    t = tref.policy_match_ref(_t(meta), _t(ml), _t(off), _t(lo), _t(hi),
                              _t(ks), _t(live), payload=_t(pw),
                              payload_len=_t(pln))
    _same(j, t)


def test_policy_match_empty_conditions_and_rules():
    """K == 0: every rule holds (an empty AND), as in the jnp oracle.
    R == 0: every row answers R (no rule matched)."""
    rng = np.random.default_rng(4)
    meta, ml, off, lo, hi, _ = tt.policy_case(rng, b=3, meta_max=6, r=4, k=3)
    empty = np.zeros((4, 0), np.int32)
    _same(jref.policy_match_ref(_j(meta), _j(ml), _j(empty), _j(empty),
                                _j(empty)),
          tref.policy_match_ref(_t(meta), _t(ml), _t(empty), _t(empty),
                                _t(empty)))
    none = np.zeros((0, 3), np.int32)
    out = tref.policy_match_ref(_t(meta), _t(ml), _t(none), _t(none),
                                _t(none))
    assert out.dtype == torch.int32 and out.tolist() == [0, 0, 0]


FUSED_OPERANDS = {
    "none": (),
    "crypto": ("keystream", "tx_keystream"),
    "policy": ("cond_off", "cond_lo", "cond_hi"),
    "policy+live": ("cond_off", "cond_lo", "cond_hi", "live"),
    "crypto+policy": ("keystream", "tx_keystream", "cond_off", "cond_lo",
                      "cond_hi"),
    "all": ("keystream", "tx_keystream", "cond_off", "cond_lo", "cond_hi",
            "live", "meta_ks"),
}


@pytest.mark.parametrize("operands", list(FUSED_OPERANDS))
@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[2]],
                         ids=["b2p8", "b5p8"])
@pytest.mark.parametrize("seed", SEEDS)
def test_fused_round_matches_jax(seed, shape, operands):
    case = tt.fused_round_case(np.random.default_rng(seed), **shape)
    base = ("stream", "meta_len", "total_len", "pool", "tables")
    opt = {k: case[k] for k in FUSED_OPERANDS[operands]}
    jm, jp, jv, jo = jref.fused_round_ref(
        *(_j(case[k]) for k in base), meta_max=shape["meta_max"],
        **{k: _j(v) for k, v in opt.items()})
    t_pool = _t(case["pool"])
    tm, tp, tv, to = tref.fused_round_ref(
        *(_t(case[k]) for k in base[:3]), t_pool, _t(case["tables"]),
        meta_max=shape["meta_max"], **{k: _t(v) for k, v in opt.items()})
    assert tp is t_pool
    for j, t in ((jm, tm), (jp, tp), (jo, to)):
        _same(j, t)
    assert (jv is None) == (tv is None)
    if jv is not None:
        _same(jv, tv)


@pytest.mark.parametrize("crypto", [False, True], ids=["plain", "ks"])
def test_fused_round_edge_rows_match_jax(crypto):
    stream, ml, tl, pool, tables, ks = tt.edge_rows_case()
    rng = np.random.default_rng(8)
    off = np.array([[-1, 0], [-2, -1], [-3, 2]], np.int32)
    lo = rng.integers(0, 500, (3, 2)).astype(np.int32)
    hi = (lo + 600).astype(np.int32)
    opt = dict(cond_off=off, cond_lo=lo, cond_hi=hi)
    if crypto:
        opt.update(keystream=ks, tx_keystream=rng.integers(
            0, 1 << 31, (3, 24)).astype(np.int32))
    args = (stream, ml, tl, pool, tables)
    jm, jp, jv, jo = jref.fused_round_ref(*map(_j, args), meta_max=8,
                                          **{k: _j(v) for k, v in opt.items()})
    tm, tp, tv, to = tref.fused_round_ref(*map(_t, args), meta_max=8,
                                          **{k: _t(v) for k, v in opt.items()})
    for j, t in ((jm, tm), (jp, tp), (jv, tv), (jo, to)):
        _same(j, t)


# ---------------------------------------------------------------------------
# dispatch: the plain version only for CPU tensors, never a silent fallback
# ---------------------------------------------------------------------------

def _small_fused():
    return tt.to_torch(tt.fused_round_case(np.random.default_rng(1), b=2,
                                           page=8, pps=2, meta_max=8))


def test_auto_on_cpu_tensors_takes_the_plain_version():
    kern.reset_launches()
    c = _small_fused()
    ptr = c["pool"].data_ptr()
    want = tref.fused_round_ref(
        c["stream"], c["meta_len"], c["total_len"], c["pool"].clone(),
        c["tables"], meta_max=8, keystream=c["keystream"],
        cond_off=c["cond_off"], cond_lo=c["cond_lo"], cond_hi=c["cond_hi"])
    got = ops.fused_round(c["stream"], c["meta_len"], c["total_len"],
                          c["pool"], c["tables"], meta_max=8, impl="auto",
                          keystream=c["keystream"], cond_off=c["cond_off"],
                          cond_lo=c["cond_lo"], cond_hi=c["cond_hi"],
                          donate_pool=True, n_buffers=2)
    assert got[1] is c["pool"] and c["pool"].data_ptr() == ptr
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    g = ops.selective_gather(c["pool"], c["tables"],
                             c["total_len"] - c["meta_len"], impl="auto")
    assert torch.equal(g, got[3])
    assert all(n == 0 for n in kern.LAUNCHES.values())


def test_in_place_anchor_keeps_the_pool_storage():
    c = _small_fused()
    ptr = c["pool"].data_ptr()
    _meta, pool = ops.selective_copy(
        c["stream"], c["meta_len"], c["total_len"], c["pool"], c["tables"],
        meta_max=8, impl="ref", keystream=c["keystream"], donate_pool=True)
    assert pool is c["pool"] and pool.data_ptr() == ptr


@pytest.mark.parametrize("op", ["selective_copy", "selective_gather",
                                "policy_match", "fused_round"])
def test_cuda_impl_on_cpu_tensors_raises(op):
    c = _small_fused()
    args = {
        "selective_copy": lambda impl: ops.selective_copy(
            c["stream"], c["meta_len"], c["total_len"], c["pool"],
            c["tables"], meta_max=8, impl=impl),
        "selective_gather": lambda impl: ops.selective_gather(
            c["pool"], c["tables"], c["total_len"], impl=impl),
        "policy_match": lambda impl: ops.policy_match(
            c["stream"][:, :8].contiguous(), c["meta_len"], c["cond_off"],
            c["cond_lo"], c["cond_hi"], impl=impl),
        "fused_round": lambda impl: ops.fused_round(
            c["stream"], c["meta_len"], c["total_len"], c["pool"],
            c["tables"], meta_max=8, impl=impl),
    }[op]
    with pytest.raises(ValueError, match="CUDA tensor"):
        args("cuda")
    for impl in ("interpret", "pallas"):
        with pytest.raises(ValueError, match="TPU"):
            args(impl)


def test_c_interface_matches_the_bound_signatures():
    """Every C entry point the wrappers bind exists in csrc/ with the
    number of arguments its ctypes signature declares."""
    text = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    found = {}
    for name, params in re.findall(
            r'extern "C" int (libra_\w+)\(([^)]*)\)', text):
        found[name] = len([p for p in params.split(",") if p.strip()])
    assert found == {k: len(v) for k, v in _build.SIGNATURES.items()}
    # the seven TPU kernels' sources, the kTLS-analogue bench's, the
    # prefill's float32 product and the serving paths' MoE layer
    assert len(list(_build.CSRC.glob("*.cu"))) == 10
    assert "compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)


class _FakeLib:
    """Stands in for the kernels' ``ctypes`` library: every entry point
    and ``libra_error_string`` accept attributes and calls."""

    def __getattr__(self, name):
        fn = lambda *a: 0  # noqa: E731
        self.__dict__[name] = fn
        return fn


def test_first_load_builds_once_and_counts_are_exact_under_threads(
        monkeypatch):
    """Worker threads reach their first launch together: sixteen threads
    (more than the cores) calling ``load()`` build and open the library
    once, and bumping one count N times each leave exactly 16 x N, with
    the interpreter switching threads as often as it can."""
    import sys
    import threading
    import time

    builds, opens = [], []

    def slow_build(verbose=False):
        builds.append(threading.get_ident())
        time.sleep(0.05)            # widen the window a race would need
        return "libfake.so"

    def fake_cdll(path):
        opens.append(path)
        return _FakeLib()

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(kern, "LAUNCHES", dict.fromkeys(kern.LAUNCHES, 0))
    n_threads, n, libs = 16, 2000, []
    start = threading.Barrier(n_threads, timeout=30)

    def worker():
        start.wait()
        libs.append(_build.load())
        for _ in range(n):
            _build.count_launch(kern.LAUNCHES, "fused_round")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert len(builds) == 1 and opens == ["libfake.so"]
    assert len(libs) == n_threads and all(lib is libs[0] for lib in libs)
    assert kern.LAUNCHES["fused_round"] == n_threads * n
    kern.reset_launches()
    assert all(v == 0 for v in kern.LAUNCHES.values())
