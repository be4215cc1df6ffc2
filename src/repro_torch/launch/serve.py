"""Serving launcher of the port: run a model under the Libra engine and
print throughput / latency / boundary-traffic stats, as the JAX package's
``repro.launch.serve`` prints them.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  python -m repro_torch.launch.serve --no-reduced --arch phi4-mini-3.8b

``--reduced`` (the default) serves the config's small same-family
variant; ``--no-reduced`` serves the published one. ``--device`` is
``cuda`` by default and raises without a GPU. Only the Libra engine is
ported; the baseline engines wait (``ROADMAP.md``, queue 1, item 6). The
engine serves the dense family only: xlstm-350m has no KV pool, and the
JAX launcher fails on it too.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.core.parser import TokenStreamParser
from repro_torch.kernels.ops import checked_device
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import LibraEngine

ENGINES = {"libra": LibraEngine}
PAGE_SIZE = 8


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="libra-proxy-125m",
                    choices=[a for a in ARCHS + ["libra-proxy-125m"]
                             if get_config(a).family == "dense"])
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--engine", default="libra", choices=list(ENGINES))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--header-len", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = checked_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, page_size=PAGE_SIZE)
    params = model.init_params(0, device=device)
    parser = TokenStreamParser(header_len=args.header_len)
    max_len = args.prompt_len + args.gen + 8
    eng = ENGINES[args.engine](model, params, max_len=max_len, parser=parser,
                               max_batch=args.batch, page_size=PAGE_SIZE,
                               device=device)

    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        eng.submit(rng.integers(1, cfg.vocab_size - 1, args.prompt_len),
                   max_new_tokens=args.gen)
    t0 = time.perf_counter()
    eng.run()
    dt = time.perf_counter() - t0
    s = eng.stats
    print(f"engine={args.engine} batch={eng.max_batch} "
          f"requests={len(eng.completed)}")
    print(f"throughput: {eng.throughput_tokens()/dt:.1f} tok/s   "
          f"p99 latency: {eng.p99_latency()*1000:.1f} ms")
    print(f"boundary traffic: h2d={s.h2d_bytes/1e3:.1f}KB "
          f"d2h={s.d2h_bytes/1e3:.1f}KB in {s.d2h_calls} transfers")
    print(f"payload: copied={s.payload_copy_bytes/1e6:.2f}MB "
          f"anchored={s.anchored_bytes/1e6:.2f}MB "
          f"zero-copy-forwarded={s.zero_copy_bytes/1e6:.2f}MB")


if __name__ == "__main__":
    main()
