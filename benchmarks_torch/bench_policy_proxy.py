"""In-data-plane L7 policy offload vs per-message Python callbacks.

The port's ``benchmarks/bench_policy_proxy.py``: the same rows, series,
repetitions, identity asserts and gate. In full mode every stack, header
and payload is :data:`common.DEPLOYMENT`'s (the tenant tag leads the
128-token header block).

Routing consults only the small metadata prefix, so the decision belongs
in the fused data plane, not in per-message Python. One shared table (one
forward rule per tenant tag, a tenant DROP, a header REWRITE, and a
no-match PUNT tail) routes the same workload two ways:

  * ``python``    -- :class:`PythonPolicyRouter`: the table evaluated
                     message by message through the ``rewrite``/``router``
                     callback slots.
  * ``offloaded`` -- ``ProxyRuntime(policy=...)``: one vectorized
                     first-match pass per batched round, fused into
                     ``recv_batch``'s metadata sweep (the host batch path,
                     as in the reference); Python only sees the PUNT tail.

Series: batched plaintext at N in {8, 64, 256} connections, plus an
hw-kTLS series at N = 64 where the offloaded match consumes ciphertext +
keystream. Gate (full mode, as in the reference): offloaded >= 1.3x
python msgs/s at N = 64, with byte-identical backend wires and Fig. 9
counter identity in every pair::

    PYTHONPATH=src python -m benchmarks_torch.bench_policy_proxy
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from benchmarks_torch.common import DEPLOYMENT, bench_args, csv, is_smoke, \
    sync
from repro_torch.core import (
    LibraStack,
    PolicyTable,
    ProxyRuntime,
    PythonPolicyRouter,
    between,
    build_message,
    drop,
    eq,
    forward,
    rewrite,
    rule,
)
from repro_torch.core.crypto import REC_HEADER

PAGE = 16

#: app metadata starts after the [MAGIC, len_meta, len_payload] header
TAG = 3

#: ACL-scale table: one forward rule per tenant tag. A per-message Python
#: first-match scan is O(rules); the fused pass is one vectorized sweep
#: over the whole round regardless of table size.
N_TENANTS = 240
TAG_DROP, TAG_REWRITE, TAG_PUNT = 245, 250, 251


def make_table(crypto: bool = False) -> PolicyTable:
    off = TAG + (REC_HEADER if crypto else 0)
    rules = [rule(forward(t % 2), eq(off, t), between(off + 1, 0, 255),
                  name=f"tenant{t}")
             for t in range(N_TENANTS)]
    rules.append(rule(drop(), eq(off, TAG_DROP), name="blocked"))
    rules.append(rule(rewrite(off + 1, 7777, backend=0), eq(off, TAG_REWRITE),
                      name="patch"))
    # everything else (TAG_PUNT) PUNTs to the callback tail
    return PolicyTable(rules)


def _load(stack: LibraStack, rt: ProxyRuntime, table: Optional[PolicyTable],
          tls: Optional[str], *, n_conns: int, n_msgs: int, payload: int,
          meta: int = 8, seed: int = 0):
    rng = np.random.default_rng(seed)
    dsts = []
    for i in range(n_conns):
        src = stack.socket("length-prefixed", tls=tls)
        pair = [stack.socket("length-prefixed", tls=tls) for _ in range(2)]
        if table is None:
            rt.channel(src, pair, name=f"ch{i}")          # offloaded
        else:
            pr = PythonPolicyRouter(table, pair, parser=src.parser,
                                    crypto=tls is not None, stack=stack)
            rt.channel(src, pair, rewrite=pr.rewrite, router=pr.router,
                       name=f"ch{i}")
        dsts.append(pair)
        tags = np.where(rng.random(n_msgs) < 0.85,
                        rng.integers(0, N_TENANTS, n_msgs),
                        rng.choice([TAG_DROP, TAG_REWRITE, TAG_PUNT], n_msgs))
        frames = [build_message(
            np.concatenate([[int(t)], rng.integers(100, 200, meta - 1)]),
            rng.integers(1000, 2000, payload))
            for t in tags]
        wire = (src.tls.seal_frames(frames, src.parser.inner) if tls
                else np.concatenate(frames))
        src.deliver(wire)
    return dsts


def run_regime(mode: str, *, n_conns: int, n_msgs: int, payload: int,
               tls: Optional[str] = None, seed: int = 0, device="cuda"):
    smoke = is_smoke()
    geo = (dict(n_shards=1, pages_per_shard=8192, page_size=PAGE) if smoke
           else DEPLOYMENT.stack_kw)
    stack = LibraStack(secret=b"policy-proxy", device=device, **geo)
    table = make_table(crypto=tls is not None)
    rt = ProxyRuntime(stack, tick_every=32, batched=True,
                      policy=table if mode == "offloaded" else None)
    dsts = _load(stack, rt,
                 None if mode == "offloaded" else table, tls,
                 n_conns=n_conns, n_msgs=n_msgs, payload=payload,
                 meta=8 if smoke else DEPLOYMENT.meta, seed=seed)
    t0 = time.perf_counter()
    rt.run()
    sync(device)
    dt = time.perf_counter() - t0
    plains = [np.concatenate([d.tls.open_wire(d.tx_wire()) if tls
                              else d.tx_wire() for d in pair])
              for pair in dsts]
    res = {
        "msgs": n_conns * n_msgs,
        "dt": dt,
        "plains": plains,
        "snapshot": stack.counters.snapshot(),
        "policy_hits": stack.counters.policy_hits,
        "policy_punts": stack.counters.policy_punts,
        "policy_drops": stack.counters.policy_drops,
        "table": table.summary(),
    }
    rt.shutdown()
    return res


def _pair(n_conns: int, n_msgs: int, payload: int, reps: int,
          tls: Optional[str] = None, device="cuda"):
    """Best-of-k offloaded + python runs of the SAME workload, with the
    identity checks the offload must not break."""
    best = {}
    for mode in ("python", "offloaded"):
        for r in range(reps):
            got = run_regime(mode, n_conns=n_conns, n_msgs=n_msgs,
                             payload=payload, tls=tls, device=device)
            if r == 0 or got["dt"] < best[mode]["dt"]:
                best[mode] = got
    o, p = best["offloaded"], best["python"]
    assert o["snapshot"] == p["snapshot"], "Fig. 9 identity broken"
    assert all(np.array_equal(a, b)
               for a, b in zip(o["plains"], p["plains"])), \
        "offloaded routing diverged from the Python callbacks"
    assert o["policy_hits"] > 0 and p["policy_hits"] == 0
    return o, p


def main(argv=None) -> None:
    device = bench_args(argv, __doc__).device
    smoke = is_smoke()
    n_msgs = 4 if smoke else 16
    payload = 24 if smoke else DEPLOYMENT.payload
    reps = 2 if smoke else 3
    series = [8, 64] if smoke else [8, 64, 256]

    ratios = {}
    for n_conns in series:
        o, p = _pair(n_conns, n_msgs, payload, reps, device=device)
        o_t = o["msgs"] / max(o["dt"], 1e-9)
        p_t = p["msgs"] / max(p["dt"], 1e-9)
        ratios[n_conns] = o_t / max(p_t, 1e-9)
        st = o["table"]
        csv(f"policy_proxy_c{n_conns}_python", 1e6 / max(p_t, 1e-9),
            f"msgs_per_s={p_t:.0f} mode=callbacks batched=True")
        csv(f"policy_proxy_c{n_conns}_offloaded", 1e6 / max(o_t, 1e-9),
            f"msgs_per_s={o_t:.0f} mode=offloaded batched=True "
            f"hits={o['policy_hits']} punts={o['policy_punts']} "
            f"drops={o['policy_drops']} matched={st['matched']}")
        csv(f"policy_proxy_c{n_conns}_speedup", 0.0,
            f"offloaded_over_python={ratios[n_conns]:.2f}x "
            f"identical=True")

    # hw-kTLS series: the match consumes ciphertext + keystream
    n_tls = 64
    o, p = _pair(n_tls, n_msgs, payload, reps, tls="hw", device=device)
    o_t = o["msgs"] / max(o["dt"], 1e-9)
    p_t = p["msgs"] / max(p["dt"], 1e-9)
    csv(f"policy_proxy_c{n_tls}_hw_ktls_python", 1e6 / max(p_t, 1e-9),
        f"msgs_per_s={p_t:.0f} mode=callbacks tls=hw")
    csv(f"policy_proxy_c{n_tls}_hw_ktls_offloaded", 1e6 / max(o_t, 1e-9),
        f"msgs_per_s={o_t:.0f} mode=offloaded tls=hw "
        f"hits={o['policy_hits']} drops={o['policy_drops']}")
    csv(f"policy_proxy_c{n_tls}_hw_ktls_speedup", 0.0,
        f"offloaded_over_python={o_t / max(p_t, 1e-9):.2f}x identical=True")

    if not smoke:
        assert ratios[64] >= 1.3, \
            f"offload under target at N=64: {ratios[64]:.2f}x < 1.3x"


if __name__ == "__main__":
    main()
