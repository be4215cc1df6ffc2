"""Serving launcher of the port: run a model under any of the four engines
and print throughput / latency / boundary-traffic stats, as the JAX
package's ``repro.launch.serve`` prints them.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --engine standard \
      --device cpu
  python -m repro_torch.launch.serve --no-reduced --arch phi4-mini-3.8b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --device cpu

``--engine`` is ``libra`` (the default), ``standard``, ``copier`` or
``static``; ``static`` sizes its batch from a 256 MiB memory budget, as the
JAX launcher does, and ignores ``--batch``. ``--reduced`` (the default)
serves the config's small same-family variant; ``--no-reduced`` serves the
published one. ``--device`` is ``cuda`` by default and raises without a
GPU. The engines serve the dense, ``moe`` and ``hybrid`` families:
xlstm-350m has no KV cache, and the JAX launcher fails on it too. Under
``hybrid`` (hymba-1.5b) only ``libra`` runs the Mamba mixers and the
attention windows; the baselines serve the model without them, as the
JAX engines do.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.core.parser import TokenStreamParser
from repro_torch.kernels.ops import checked_device
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import (
    CopierEngine,
    LibraEngine,
    StandardEngine,
    StaticEngine,
)

#: the families the engines serve: xlstm-350m (``ssm``) has no KV cache,
#: and the engines feed ``vlm`` no image and ``encdec`` no frames, as the
#: JAX package's cannot (``ROADMAP.md``, F3): internvl2-76b and
#: whisper-medium are driven through ``prefill`` / ``decode_step``
SERVED_FAMILIES = ("dense", "moe", "hybrid")
ENGINES = {"libra": LibraEngine, "standard": StandardEngine,
           "copier": CopierEngine, "static": StaticEngine}
PAGE_SIZE = 8
STATIC_MEMORY_BUDGET = 1 << 28


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="libra-proxy-125m",
                    choices=[a for a in ARCHS + ["libra-proxy-125m"]
                             if get_config(a).family in SERVED_FAMILIES])
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
    kw = dict(max_len=max_len, parser=parser, device=device)
    if args.engine == "static":
        kw["memory_budget"] = STATIC_MEMORY_BUDGET
    else:
        kw["max_batch"] = args.batch
    if args.engine == "libra":
        kw["page_size"] = PAGE_SIZE
    eng = ENGINES[args.engine](model, params, **kw)

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
