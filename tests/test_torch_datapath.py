"""End-to-end twins: one seeded proxy trace through the JAX package's
``repro.core`` and through the port's ``repro_torch.core`` (``device="cpu"``)
must give identical wire bytes, ``CopyCounters``, policy verdict stats and
``xfer`` counts, for each ``batch_impl`` pair, plaintext and hw-kTLS. Plus
twins of the device pool's dirty-row and int32-range behaviour, carrying a
JAX pool's state across with ``load_state``, the import rule of the port,
and the no-silent-CPU rule for ``device="cuda"``."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core.crypto import REC_HEADER
from repro.core.policy import payload_at as j_payload_at
from repro.core.vpi import VpiRegistry as JVpiRegistry
from repro_torch.core.policy import payload_at as t_payload_at
from repro_torch.core.vpi import VpiRegistry as TVpiRegistry

ROOT = Path(__file__).resolve().parents[1]
PKGS = {"jax": (jcore, j_payload_at, {}),
        "torch": (tcore, t_payload_at, {"device": "cpu"})}
TAG = 3     # app metadata starts after the [MAGIC, len_meta, len_payload]


def _table(core, payload_at, tls):
    """Metadata drop + payload-prefix forward + metadata forward (offsets
    shift past the record header under hw-kTLS)."""
    off = (REC_HEADER if tls else 0) + TAG
    return core.PolicyTable([
        core.rule(core.drop(), core.between(off, 196, 199)),
        core.rule(core.forward(1), payload_at(0, 1950, 2000)),
        core.rule(core.forward(0), core.between(off, 100, 199)),
    ])


def _run(pkg, impl, tls, *, n_chans=4, n_msgs=3, seed=5):
    core, payload_at, kw = PKGS[pkg]
    stack = core.LibraStack(n_shards=2, pages_per_shard=64, page_size=8,
                            secret=b"twin", **kw)
    table = _table(core, payload_at, tls)
    rt = core.ProxyRuntime(stack, tick_every=8, batched=True,
                           batch_impl=impl, policy=table)
    rng = np.random.default_rng(seed)

    def frame():
        # tags and first payload tokens drawn so every rule gets hits
        meta = np.concatenate([[rng.choice([120, 150, 197])],
                               rng.integers(100, 200, 3)])
        payload = rng.integers(1000, 2000, int(rng.integers(9, 40)))
        payload[0] = rng.choice([1500, 1975])
        return core.build_message(meta, payload)

    for i in range(n_chans):
        src = stack.socket("length-prefixed", tls=tls)
        dsts = [stack.socket("length-prefixed", tls=tls) for _ in range(2)]
        rt.channel(src, dsts, name=f"ch{i}")
        frames = [frame() for _ in range(n_msgs)]
        src.deliver(src.tls.seal_frames(frames, src.parser.inner) if tls
                    else np.concatenate(frames))
    rt.run()
    wires = [(d.tls.open_wire(d.tx_wire()) if tls else d.tx_wire()).tolist()
             for ch in rt.channels for d in ch.dsts]
    out = dict(wires=wires, msgs=rt.messages_forwarded(),
               counters=dataclasses.asdict(stack.counters),
               verdicts=table.summary(), xfer=dict(stack.pool.xfer))
    rt.shutdown()
    assert stack.alloc.free_pages == stack.alloc.total_pages
    return out


def _jax_gathers_every_round_on_device(monkeypatch):
    """The JAX package serves batched gathers of up to four rows on the host
    (``_SMALL_GATHER_ROWS``, sized for a TPU launch); the port gathers every
    device-plane round on the device. Setting the threshold to 0 makes the
    reference do the same, so the two count the same ``xfer``."""
    monkeypatch.setattr(f"{jcore.__name__}.stack._SMALL_GATHER_ROWS", 0)


@pytest.mark.parametrize("tls", [None, "hw"], ids=["plain", "hw"])
@pytest.mark.parametrize("impl", ["host", "ref", "fused-round:ref", "auto",
                                  "fused-round"])
def test_port_matches_jax_end_to_end(impl, tls, monkeypatch):
    """``'auto'`` and ``'fused-round'`` resolve to the plain version on CPU
    tensors in the port, and to the jnp oracle on a CPU backend in JAX."""
    _jax_gathers_every_round_on_device(monkeypatch)
    j = _run("jax", impl, tls)
    t = _run("torch", impl, tls)
    assert t["msgs"] == j["msgs"] > 0
    assert t["wires"] == j["wires"]
    assert t["counters"] == j["counters"]
    assert t["verdicts"] == j["verdicts"]
    assert t["counters"]["device_fallbacks"] == 0
    assert all(h > 0 for h in t["verdicts"]["rule_hits"])
    jx, tx = dict(j["xfer"]), dict(t["xfer"])
    assert tx.pop("host_gathers") == 0
    # the port counts every device round as donated (the pool tensor is
    # updated in place by every kernel); JAX counts donated anchor rounds
    assert tx.pop("donated_rounds") == tx["device_rounds"]
    assert jx.pop("donated_rounds") == jx["anchor_rounds"]
    assert tx == jx
    assert tx["pool_syncs"] == 0
    if impl == "host":
        assert tx["device_rounds"] == 0
    else:
        assert tx["device_rounds"] > 0
    if impl.startswith("fused-round"):
        assert tx["fused_rounds"] == tx["anchor_rounds"] > 0


# ---------------------------------------------------------------------------
# device pool twins: dirty rows, lazy host views, int32-range bounces
# ---------------------------------------------------------------------------

def _stack(pkg, **kw):
    core, _, extra = PKGS[pkg]
    kw.setdefault("n_shards", 4)
    kw.setdefault("pages_per_shard", 64)
    kw.setdefault("page_size", 16)
    kw.setdefault("secret", b"dp")
    return core.LibraStack(**kw, **extra)


def _lazy_views(pkg):
    core = PKGS[pkg][0]
    stack = _stack(pkg)
    socks = [stack.socket("length-prefixed") for _ in range(3)]
    rng = np.random.default_rng(9)
    payloads = [rng.integers(1000, 2000, 40) for _ in socks]
    for s, p in zip(socks, payloads):
        s.deliver(core.build_message(np.arange(4), p))
    assert len(stack.recv_batch(socks, impl="ref")) == 3
    pool = stack.pool
    assert len(pool.dirty_rows()) > 0
    d2h_before = pool.xfer["d2h_tokens"]
    (pages, ln), = socks[0].connection.anchored.values()
    assert np.array_equal(pool.read_payload(pages, ln), payloads[0])
    assert pool.xfer["d2h_tokens"] > d2h_before
    assert len(pool.dirty_rows()) > 0
    data = pool.data.copy()
    assert len(pool.dirty_rows()) == 0
    return data, dict(pool.xfer)


def test_device_rounds_materialize_lazily_like_jax():
    j_data, j_x = _lazy_views("jax")
    t_data, t_x = _lazy_views("torch")
    assert np.array_equal(j_data, t_data)
    assert t_x["d2h_tokens"] == j_x["d2h_tokens"]
    assert t_x["h2d_tokens"] == j_x["h2d_tokens"]


def _interleave(pkg):
    core = PKGS[pkg][0]
    stack = _stack(pkg, n_shards=1, pages_per_shard=8)
    rng = np.random.default_rng(13)
    s1, d1 = stack.socket_pair("length-prefixed")
    p1 = rng.integers(1000, 2000, 64)
    s1.deliver(core.build_message(np.arange(3), p1))
    buf, _ = stack.recv_batch([s1], impl="ref")[s1.fileno()]
    s1.forward(d1, buf)
    assert np.array_equal(d1.tx_wire()[-64:], p1)
    s2, d2 = stack.socket_pair("length-prefixed")
    p2 = rng.integers(3000, 4000, 64)
    s2.deliver(core.build_message(np.arange(3), p2))
    buf2, _ = s2.recv(1 << 20)
    h2d_before = stack.pool.xfer["h2d_tokens"]
    assert stack.forward_batch([(s2, d2, buf2, None)],
                               impl="ref")[0][0] == "ok"
    assert np.array_equal(d2.tx_wire()[-64:], p2)
    assert stack.pool.xfer["h2d_tokens"] > h2d_before
    assert stack.pool.xfer["pool_syncs"] == 0
    assert stack.counters.device_fallbacks == 0
    return dict(stack.pool.xfer)


def test_host_writes_interleave_with_device_rounds_like_jax(monkeypatch):
    _jax_gathers_every_round_on_device(monkeypatch)
    jx, tx = _interleave("jax"), _interleave("torch")
    assert tx["host_gathers"] == 0
    for k in ("h2d_tokens", "d2h_tokens", "device_rounds", "anchor_rounds"):
        assert tx[k] == jx[k], k


def _bounce(pkg):
    core = PKGS[pkg][0]
    registry = JVpiRegistry if pkg == "jax" else TVpiRegistry
    stack = _stack(pkg, n_shards=1, pages_per_shard=6)
    huge = np.array([2 ** 40 + 5, -(2 ** 35), 2 ** 31, 7] * 8, np.int64)
    big = stack.socket("length-prefixed")
    big.deliver(core.build_message(np.arange(3), huge))
    big.recv(1 << 20)
    other = stack.socket("length-prefixed")
    other.deliver(core.build_message(
        np.arange(3), np.random.default_rng(2).integers(0, 9, 16)))
    assert len(stack.recv_batch([other], impl="ref")) == 1
    assert stack.counters.device_fallbacks == 0
    (vpi, (pages, ln)), = big.connection.anchored.items()
    dst = stack.socket("length-prefixed")
    buf = np.concatenate([np.array([17, 3, len(huge)], np.int64),
                          np.arange(3),
                          np.array([registry.to_token(vpi)], np.int64)])
    assert stack.forward_batch([(big, dst, buf, None)],
                               impl="ref")[0][0] == "ok"
    assert stack.counters.device_fallbacks == 1
    assert np.array_equal(dst.tx_wire()[-len(huge):], huge)
    return dict(stack.pool.xfer)


def test_out_of_range_rows_bounce_to_host_like_jax(monkeypatch):
    _jax_gathers_every_round_on_device(monkeypatch)
    jx, tx = _bounce("jax"), _bounce("torch")
    assert tx["host_gathers"] == 1
    for k in ("h2d_tokens", "d2h_tokens", "device_rounds"):
        assert tx[k] == jx[k], k


@pytest.mark.parametrize("rows", [1, 2, 4])
def test_small_gathers_run_on_the_device(rows):
    """A batched forward of a handful of rows is one device gather, not a
    host gather of rows pulled down from the resident pool."""
    stack = _stack("torch")
    rng = np.random.default_rng(31 + rows)
    pairs = [stack.socket_pair("length-prefixed") for _ in range(rows)]
    payloads = [rng.integers(1000, 2000, 40) for _ in pairs]
    for (src, _dst), p in zip(pairs, payloads):
        src.deliver(tcore.build_message(np.arange(3), p))
    bufs = stack.recv_batch([src for src, _ in pairs], impl="ref")
    rounds = stack.pool.xfer["device_rounds"]
    sends = [(src, dst, bufs[src.fileno()][0], None) for src, dst in pairs]
    assert [st for st, _ in stack.forward_batch(sends, impl="ref")] == \
        ["ok"] * rows
    for (_src, dst), p in zip(pairs, payloads):
        assert np.array_equal(dst.tx_wire()[-len(p):], p)
    assert stack.pool.xfer["device_rounds"] == rounds + 1
    assert stack.pool.xfer["host_gathers"] == 0
    assert stack.counters.device_fallbacks == 0


def test_upload_of_out_of_range_rows_raises_device_range_error():
    stack = _stack("torch", n_shards=1, pages_per_shard=4)
    pool = stack.pool
    pool._ensure_device()
    pool._flat[1, 0] = 2 ** 40
    pool._host_dirty[1] = True
    with pytest.raises(tcore.DeviceRangeError):
        pool._upload_rows(np.array([1], np.int64))
    assert pool._host_dirty[1]                 # nothing was touched


def _int64_reuse(pkg):
    core = PKGS[pkg][0]
    stack = _stack(pkg, n_shards=1, pages_per_shard=2)
    rng = np.random.default_rng(21)
    a = stack.socket("length-prefixed")
    a.deliver(core.build_message(np.arange(3), rng.integers(0, 9, 16)))
    ra = stack.recv_batch([a], impl="ref")
    dst = stack.socket("length-prefixed")
    a.forward(dst, ra[a.fileno()][0])
    big = stack.socket("length-prefixed")
    huge = np.array([2 ** 40 + 1] * 16, np.int64)
    big.deliver(core.build_message(np.arange(3), huge))
    bbuf, _ = big.recv(1 << 20)
    big.forward(dst, bbuf)
    assert np.array_equal(dst.tx_wire()[-16:], huge)
    c = stack.socket("length-prefixed")
    pc = rng.integers(0, 9, 16)
    c.deliver(core.build_message(np.arange(3), pc))
    assert len(stack.recv_batch([c], impl="ref")) == 1
    (pages, ln), = c.connection.anchored.values()
    assert np.array_equal(stack.pool.read_payload(pages, ln), pc)
    return stack.counters.device_fallbacks


def test_int64_rows_survive_device_round_reusing_them_like_jax():
    assert _int64_reuse("torch") == _int64_reuse("jax") >= 1


def test_whole_pool_view_writes_stay_coherent():
    core = tcore
    stack = _stack("torch")
    src, dst = stack.socket_pair("length-prefixed")
    p = np.random.default_rng(3).integers(1000, 2000, 32)
    src.deliver(core.build_message(np.arange(3), p))
    buf, _ = stack.recv_batch([src], impl="ref")[src.fileno()]
    (pages, ln), = src.connection.anchored.values()
    row = stack.alloc.flat_pid(pages[0])
    patched = np.array([9001, 9002, 9003, 9004], np.int64)
    stack.pool.data.reshape(-1, stack.alloc.page_size)[row, :4] = patched
    assert stack.forward_batch([(src, dst, buf, None)],
                               impl="ref")[0][0] == "ok"
    assert np.array_equal(dst.tx_wire()[-ln:][:4], patched)
    assert stack.pool.xfer["pool_syncs"] == 0


def test_legacy_host_pool_pays_pool_syncs_like_jax():
    def run(pkg):
        core = PKGS[pkg][0]
        stack = _stack(pkg, device_pool=False)
        socks = [stack.socket("length-prefixed") for _ in range(3)]
        for i, s in enumerate(socks):
            s.deliver(core.build_message(np.arange(4),
                                         np.arange(40) + 100 * i))
        stack.recv_batch(socks, impl="ref")
        return dict(stack.pool.xfer), stack.pool.data.copy()
    (jx, jd), (tx, td) = run("jax"), run("torch")
    assert tx == jx and tx["pool_syncs"] == 1
    assert np.array_equal(jd, td)


def test_load_state_round_trips_a_jax_pool():
    """Start the port from the JAX pool's resident rows and dirty masks:
    the same later rounds give the same host views and gathers."""
    def fill(stack, core):
        socks = [stack.socket("length-prefixed") for _ in range(4)]
        rng = np.random.default_rng(17)
        for s in socks:
            s.deliver(core.build_message(np.arange(5),
                                         rng.integers(1000, 2000, 50)))
        stack.recv_batch(socks, impl="ref")
        return socks
    jstack = _stack("jax")
    jsocks = fill(jstack, jcore)
    jpool = jstack.pool
    tstack = _stack("torch")
    tpool = tstack.pool
    tpool.load_state(np.asarray(jpool._dev), jpool._host_dirty,
                     jpool._dev_dirty)
    assert tpool.resident and tpool._dev.dtype == torch.int32
    assert np.array_equal(tpool.dirty_rows(), jpool.dirty_rows())
    tables = np.full((4, 4), -1, np.int32)
    lengths = np.zeros((4,), np.int32)
    for i, s in enumerate(jsocks):
        (pages, ln), = s.connection.anchored.values()
        lengths[i] = ln
        for j, pg in enumerate(pages):
            tables[i, j] = jstack.alloc.flat_pid(pg)
    jg = jpool.gather_batch_device(tables, lengths, impl="ref")
    tg = tpool.gather_batch_device(tables, lengths, impl="ref")
    assert np.array_equal(jg, tg)
    assert np.array_equal(np.asarray(jpool._dev), tpool._dev.numpy())
    # the port's host mirror agrees once materialized
    jpool.materialize()
    tpool.materialize()
    assert np.array_equal(jpool.data, tpool.data)


def test_residency_is_lazy_for_host_only_workloads():
    """A stack left on its default device ("cuda") that never runs a
    device round never touches the device, GPU or not."""
    stack = tcore.LibraStack(n_shards=2, pages_per_shard=64, page_size=8,
                             secret=b"lazy")
    rt = tcore.ProxyRuntime(stack, batched=True, batch_impl="host")
    src, dst = stack.socket_pair("length-prefixed")
    rt.channel(src, dst)
    src.deliver(tcore.build_message(np.arange(4), np.arange(30) + 7))
    rt.run()
    assert rt.messages_forwarded() == 1
    assert not stack.pool.resident
    assert stack.pool.xfer["h2d_tokens"] == 0
    rt.shutdown()


@pytest.mark.parametrize("impl", ["ref", "auto", "fused-round"])
def test_cuda_stack_without_gpu_raises_at_first_device_round(impl):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU rule cannot be exercised")
    stack = tcore.LibraStack(n_shards=2, pages_per_shard=64, page_size=8,
                             secret=b"nogpu", device="cuda")
    socks = [stack.socket("length-prefixed") for _ in range(2)]
    for s in socks:
        s.deliver(tcore.build_message(np.arange(4), np.arange(30)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stack.recv_batch(socks, impl=impl)
    assert stack.alloc.free_pages == stack.alloc.total_pages
    assert not stack.pool.resident


def test_policy_device_match_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU rule cannot be exercised")
    table = _table(tcore, t_payload_at, None)
    metas = np.full((2, 8), 150, np.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        table.match_batch(metas, np.array([8, 8], np.int32), impl="auto",
                          device="cuda")


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "scripts").glob("*_torch.py"))
    files += sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(files) > 20
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}: {n}")
    assert bad == []
