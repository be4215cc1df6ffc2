"""Paper Fig. 6c/6d at stack level: the kTLS-analogue encrypted datapath
through the socket facade.

The port's ``benchmarks/bench_ktls_proxy.py``: the same rows, regimes,
repetitions and identity assert. One shared ``LibraStack`` drives an L7
proxy (``ProxyRuntime(batched=True)``, N client-backend flows) and a
``LibraEngine`` serving handle (``LibraEngine(..., stack=stack)``), in four
regimes:

  * ``plaintext`` -- the batched datapath, unencrypted.
  * ``sw``        -- software kTLS: a separate decrypt pass before
                     anchoring and an encrypt-and-copy pass after
                     gathering, per message; sw sockets are not admissible
                     to the fused batch.
  * ``hw``        -- NIC-inline kTLS: the cipher fused into the
                     selective-copy scatter/gather of the host batch path.
  * ``hw_fused``  -- the hw regime served by the one-kernel scheduling
                     round (``batch_impl='fused-round'``, the reference's
                     ``'fused-round:ref'``): anchor + RX keystream XOR +
                     speculative TX-encrypted egress gather in one launch
                     a round.

The engine's KV pages are the stack's pages (``PagedKVPool`` raises on a
page-size mismatch), so the bench keeps the reference's page of 16 tokens
and its sizes in both modes: :data:`common.DEPLOYMENT`'s pages of 1024
tokens would not fit the engine. Full mode serves the full
``libra-proxy-125m`` (``common.proxy_model``), smoke the reduced one.

The hw:sw throughput ratio is recorded as an artifact row (``*_ratio``)
beside the paper's ~2.0x Fig. 6c/6d headline; every regime must forward
byte-identical plaintext (checked by decrypting the backend wires)::

    PYTHONPATH=src python -m benchmarks_torch.bench_ktls_proxy
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from benchmarks_torch.common import bench_args, csv, is_smoke, proxy_model, \
    record, sync
from repro_torch.core import LibraStack, ProxyRuntime, build_message, \
    open_stream

PAGE = 16


def _load(stack: LibraStack, rt: ProxyRuntime, tls: Optional[str], *,
          n_conns: int, n_msgs: int, payload: int, meta: int = 8,
          seed: int = 0):
    rng = np.random.default_rng(seed)
    dsts, wants = [], []
    for i in range(n_conns):
        src = stack.socket("length-prefixed", tls=tls)
        dst = stack.socket("length-prefixed", tls=tls)
        rt.channel(src, dst, name=f"ch{i}")
        dsts.append(dst)
        frames = [build_message(rng.integers(100, 200, meta),
                                rng.integers(1000, 2000, payload))
                  for _ in range(n_msgs)]
        wants.append(np.concatenate(frames))
        wire = (src.tls.seal_frames(frames, src.parser.inner) if tls
                else np.concatenate(frames))
        src.deliver(wire)
    return dsts, wants


def _make_engine(stack: LibraStack, model, params, *, max_new: int,
                 device="cuda"):
    from repro_torch.serving.engine import LibraEngine

    eng = LibraEngine(model, params, max_batch=2, max_len=48,
                      page_size=PAGE, stack=stack, device=device)
    rng = np.random.default_rng(7)
    for p in [rng.integers(1, 255, 16) for _ in range(2)]:
        eng.submit(p, max_new_tokens=max_new)
    return eng


def run_regime(tls: Optional[str], *, n_conns: int, n_msgs: int,
               payload: int, model_bundle=None, max_new: int = 4,
               seed: int = 0, batch_impl: str = "host", device="cuda"):
    """One shared stack, proxy + engine, one regime. Returns a result dict
    (proxy timing excludes the interleaved engine steps and vice versa;
    each window ends with :func:`common.sync`)."""
    stack = LibraStack(n_shards=1, pages_per_shard=8192, page_size=PAGE,
                       secret=b"ktls-proxy", device=device)
    rt = ProxyRuntime(stack, tick_every=32, batched=True,
                      batch_impl=batch_impl)
    dsts, wants = _load(stack, rt, tls, n_conns=n_conns, n_msgs=n_msgs,
                        payload=payload, seed=seed)
    eng = None
    if model_bundle is not None:
        _, model, params = model_bundle
        eng = _make_engine(stack, model, params, max_new=max_new,
                           device=device)

    proxy_dt = engine_dt = 0.0
    while True:
        t0 = time.perf_counter()
        progressed = rt.step()
        sync(device)
        proxy_dt += time.perf_counter() - t0
        if eng is not None and (eng.waiting or eng.active):
            t1 = time.perf_counter()
            eng.step()          # same pool/registry/clock as the proxy round
            sync(device)
            engine_dt += time.perf_counter() - t1
        if progressed == 0 and not (eng is not None
                                    and (eng.waiting or eng.active)):
            break

    plains = [open_stream(d.tls.tx_key, d.tx_wire()) if tls else d.tx_wire()
              for d in dsts]
    res = {
        "msgs": rt.messages_forwarded(),
        "proxy_dt": proxy_dt,
        "plains": plains,
        "wants": wants,
        "crypto_copied": stack.counters.crypto_copied,
        "snapshot": stack.counters.snapshot(),
        "engine_tokens": eng.throughput_tokens() if eng is not None else 0,
        "engine_dt": engine_dt,
    }
    rt.shutdown()
    return res


def main(argv=None) -> None:
    device = bench_args(argv, __doc__).device
    smoke = is_smoke()
    n_conns = 64
    n_msgs = 8 if smoke else 32
    payload = 96
    reps = 2 if smoke else 3
    max_new = 2 if smoke else 6

    # one model serves every regime's engine handle (the engine is tls-
    # independent; what is measured is coexistence on the shared stack)
    model_bundle = proxy_model(page_size=PAGE, device=device)

    regimes = ((None, "plaintext", "host"), ("sw", "sw", "host"),
               ("hw", "hw", "host"), ("hw", "hw_fused", "fused-round"))
    best = {}
    for tls, name, impl in regimes:
        for r in range(reps):     # interleaved best-of-k, same workload
            got = run_regime(tls, n_conns=n_conns, n_msgs=n_msgs,
                             payload=payload,
                             model_bundle=(model_bundle if r == 0 else None),
                             max_new=max_new, batch_impl=impl, device=device)
            if r == 0:
                best[name] = got
            elif got["proxy_dt"] < best[name]["proxy_dt"]:
                got["engine_tokens"] = best[name]["engine_tokens"]
                got["engine_dt"] = best[name]["engine_dt"]
                best[name] = got

    # byte-identical forwarded plaintext across all regimes
    identical = all(
        np.array_equal(p, w)
        for r in best.values() for p, w in zip(r["plains"], r["wants"]))
    for name, r in best.items():
        tput = r["msgs"] / max(r["proxy_dt"], 1e-9)
        e_tput = r["engine_tokens"] / max(r["engine_dt"], 1e-9)
        csv(f"fig6cd_ktls_proxy_c{n_conns}_{name}",
            1e6 / max(tput, 1e-9),
            f"msgs_per_s={tput:.0f} crypto_copied={r['crypto_copied']} "
            f"engine_toks_per_s={e_tput:.0f} "
            f"engine_tokens={r['engine_tokens']} shared_stack=True")
    hw_t = best["hw"]["msgs"] / max(best["hw"]["proxy_dt"], 1e-9)
    fu_t = best["hw_fused"]["msgs"] / max(best["hw_fused"]["proxy_dt"], 1e-9)
    sw_t = best["sw"]["msgs"] / max(best["sw"]["proxy_dt"], 1e-9)
    pl_t = best["plaintext"]["msgs"] / max(best["plaintext"]["proxy_dt"], 1e-9)
    csv(f"fig6cd_ktls_proxy_c{n_conns}_hw_over_sw", 0.0,
        f"hw_over_sw={hw_t / max(sw_t, 1e-9):.2f}x "
        f"hw_fused_over_sw={fu_t / max(sw_t, 1e-9):.2f}x "
        f"hw_over_plain={hw_t / max(pl_t, 1e-9):.2f}x "
        f"plaintext_identical={identical}")
    # the hw:sw throughput ratio as a trajectory metric (the paper's Fig.
    # 6c/6d headline is ~2.0x): check_bench_trend_torch.py gates
    # `hw_over_sw` like msgs_per_s
    record(f"fig6cd_ktls_proxy_c{n_conns}_ratio",
           hw_over_sw=hw_t / max(sw_t, 1e-9),
           hw_fused_over_sw=fu_t / max(sw_t, 1e-9),
           hw_over_plain=hw_t / max(pl_t, 1e-9),
           paper_target_hw_over_sw=2.0)
    assert identical, "regimes disagree on forwarded plaintext"


if __name__ == "__main__":
    main()
