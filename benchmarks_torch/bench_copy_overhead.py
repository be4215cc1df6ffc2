"""Paper Fig. 1a + Table 2: how much of the step cost is the copy tax, and
how small the metadata really is.

The port's ``benchmarks/bench_copy_overhead.py``: the same rows. Fig. 1a
analogue: the fraction of the standard engine's data movement that is
payload copying (the re-materialised KV cache and the logits shipped) vs
Libra's metadata-only movement, at two contexts (full mode only, as in
the reference; the full ``libra-proxy-125m``). Table 2 analogue: the
metadata fraction per built-in parser policy, read from the stack's copy
counters after one message crossed a ``LibraSocket`` (in full mode a
:data:`common.DEPLOYMENT` message on its stack)::

    PYTHONPATH=src python -m benchmarks_torch.bench_copy_overhead
"""
from __future__ import annotations

import numpy as np

from benchmarks_torch.common import (
    BUILDERS,
    DEPLOYMENT,
    bench_args,
    csv,
    is_smoke,
    prompts_for,
    proxy_model,
    run_engine,
    stream_stack,
)


def engine_section(device="cuda") -> None:
    from repro_torch.serving.engine import LibraEngine, StandardEngine

    cfg, model, params = proxy_model(device=device)
    for ctx in (32, 256):
        prompts = prompts_for(cfg.vocab_size, 4, ctx)
        gen = 8
        libra, t_l = run_engine(LibraEngine, model, params, prompts, gen,
                                max_batch=4, max_len=ctx + gen + 8,
                                page_size=8, device=device)
        std, t_s = run_engine(StandardEngine, model, params, prompts, gen,
                              max_batch=4, max_len=ctx + gen + 8,
                              device=device)
        s = std.stats
        copy_frac = s.payload_copy_bytes / max(
            s.payload_copy_bytes + s.d2h_bytes + s.h2d_bytes, 1)
        l = libra.stats
        libra_frac = l.payload_copy_bytes / max(
            l.anchored_bytes + l.h2d_bytes + l.d2h_bytes, 1)
        csv(f"fig1a_copy_fraction_std_ctx{ctx}", t_s * 1e6 / max(s.steps, 1),
            f"copy_frac={copy_frac:.3f}")
        csv(f"fig1a_copy_fraction_libra_ctx{ctx}", t_l * 1e6 / max(l.steps, 1),
            f"copy_frac={libra_frac:.3f}")


def table2_section(device="cuda") -> None:
    """Metadata fraction per protocol policy, through the socket facade."""
    smoke = is_smoke()
    rng = np.random.default_rng(0)
    meta = rng.integers(100, 200, 12 if smoke else DEPLOYMENT.meta)
    payload = rng.integers(1000, 2000, 2048 if smoke else DEPLOYMENT.payload)
    geo = (dict(pages=2048, page_size=16) if smoke
           else dict(pages=DEPLOYMENT.pages, page_size=DEPLOYMENT.page))
    for proto, build in BUILDERS.items():
        stack = stream_stack(device=device, **geo)
        src, dst = stack.socket_pair(proto)
        src.deliver(build(meta, payload))
        logical = rx_copied = 0
        while src.rx_available() > 0:
            # Table 2 is a recv-boundary metric: meter the recv calls only,
            # excluding the send side's own metadata copy
            before = stack.counters.total_user_copies()
            buf, n = src.recv(1 << 20)
            if n == 0:
                break
            logical += n
            rx_copied += stack.counters.total_user_copies() - before
            src.forward(dst, buf)
        frac = rx_copied / max(logical, 1)
        csv(f"table2_meta_fraction_{proto}", 0.0,
            f"rx_copied={rx_copied}tok of {logical} ({frac:.4f}) "
            f"zerocopy={stack.counters.zero_copied}")


def main(argv=None) -> None:
    device = bench_args(argv, __doc__).device
    table2_section(device)
    if not is_smoke():
        engine_section(device)


if __name__ == "__main__":
    main()
