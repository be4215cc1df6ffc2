"""Paper Fig. 6a analogue at the stream level: multi-connection proxy
throughput through the POSIX facade (LibraStack/LibraSocket/ProxyRuntime),
selective copy vs the native full-copy path, across payload sizes and
connection counts with mixed protocol parsers.

The port's ``benchmarks/bench_proxy_runtime.py``: the same rows, sweeps
and repetitions, on stacks of :data:`common.DEPLOYMENT`'s pool, pages and
header in full mode (the payload sweep is the reference's). Reported:
messages/s, user-boundary copied tokens per payload token (the copy tax),
and the Fig. 9 counter breakdown::

    PYTHONPATH=src python -m benchmarks_torch.bench_proxy_runtime
"""
from __future__ import annotations

from benchmarks_torch.common import bench_args, csv, is_smoke, run_stream, \
    stream_kw

MIXED = ["length-prefixed", "delimiter", "chunked"]


def run_once(*, n_conns: int, n_msgs: int, payload: int, selective: bool,
             budget=None, parsers=None, device="cuda"):
    return run_stream(n_conns=n_conns, n_msgs=n_msgs, payload=payload,
                      parsers=parsers or MIXED, budget=budget,
                      selective=selective, device=device, **stream_kw())


def main(argv=None) -> None:
    device = bench_args(argv, __doc__).device
    smoke = is_smoke()
    payloads = (64,) if smoke else (64, 256, 1024)
    conn_counts = (4,) if smoke else (2, 8, 32)
    n_msgs = 4 if smoke else 16

    for payload in payloads:
        for n_conns in conn_counts:
            rows = {}
            for name, selective in (("libra", True), ("fullcopy", False)):
                stack, rt, msgs, dt = run_once(
                    n_conns=n_conns, n_msgs=n_msgs, payload=payload,
                    selective=selective, device=device)
                c = stack.counters
                useful = rt.logical_bytes()
                copy_tax = c.total_user_copies() / max(useful, 1)
                rows[name] = (msgs / max(dt, 1e-9), copy_tax, c)
            # copy_tax (user-boundary tokens per logical token) is the figure
            # of merit: the wall clock of these host paths is Python
            # per-message overhead, not data movement
            base = rows["fullcopy"][1]
            for name, (tput, tax, c) in rows.items():
                csv(f"stream_proxy_p{payload}_c{n_conns}_{name}",
                    1e6 / max(tput, 1e-9),
                    f"msgs_per_s={tput:.0f} copy_tax={tax:.3f} "
                    f"copy_reduction={base/max(tax,1e-9):.1f}x "
                    f"meta={c.meta_copied} full={c.full_copied} "
                    f"zerocopy={c.zero_copied}")

    # send-budget sensitivity: partial sends through the runtime
    for budget in (32, 256):
        stack, rt, msgs, dt = run_once(n_conns=4, n_msgs=n_msgs, payload=256,
                                       selective=True, budget=budget,
                                       device=device)
        partials = sum(ch.stats.partial_sends for ch in rt.channels)
        csv(f"stream_proxy_budget{budget}", dt * 1e6 / max(msgs, 1),
            f"msgs={msgs} partial_sends={partials} "
            f"rounds={rt.rounds}")


if __name__ == "__main__":
    main()
