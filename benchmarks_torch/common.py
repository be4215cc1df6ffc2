"""Shared benchmark utilities of the port's benches.

The port's copy of ``benchmarks/common.py``: the smoke switch, the
stream-level workloads (:data:`BUILDERS`, :func:`stream_stack`,
:func:`run_stream`, :func:`load_proxy`), the engine helpers
(:func:`time_fn`, :func:`run_engine`, :func:`prompts_for`,
:func:`proxy_model`), the CSV line and the machine-readable
``BENCH_<name>.json`` rows (:func:`record`, :func:`counters_fields`,
:func:`flush_artifact`). Every helper that builds a stack, an engine or
parameters takes ``device`` (``"cuda"`` by default: with no card a device
round, an engine or ``init_params`` raises; ``"cpu"`` only when the caller
asks). Every timed window ends with :func:`sync`, so on the card it
covers the device work it launched.

Two modes, as in the reference:

* ``LIBRA_BENCH_SMOKE=1``: the reference's sizes, a seconds-long gate,
  and the reduced ``libra-proxy-125m``.
* full (the card): the datapath benches run at :data:`DEPLOYMENT` (pages
  of 1024 tokens, a 128-token header block, 8192-token payloads, a 128 MiB
  resident pool a stack) and the engine benches serve the full
  ``libra-proxy-125m``. The series, sweeps, repetitions and gates are the
  reference's in both modes.

Artifacts go to ``results/bench_torch/`` (:data:`OUT_DIR`), never to
``results/bench/``, whose files belong to the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import (
    LibraStack,
    ProxyRuntime,
    build_chunked_message,
    build_delimited_message,
    build_message,
)

#: where the port's benches write their artifacts
OUT_DIR = str(Path(__file__).resolve().parents[1] / "results" / "bench_torch")


def is_smoke() -> bool:
    """``LIBRA_BENCH_SMOKE=1``: reduced sizes, a seconds-long gate."""
    return os.environ.get("LIBRA_BENCH_SMOKE", "") == "1"


def bench_args(argv=None, doc: str = "") -> argparse.Namespace:
    """``--device`` (default ``cuda``) of a bench's ``main(argv)``, made
    ready by :func:`prepare`."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0]
                                 if doc.strip() else None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    prepare(args.device)
    return args


def prepare(device) -> None:
    """Raise when ``device`` names a card and there is none; on a card,
    build and load the kernels, so that no timed window holds their
    build."""
    from repro_torch.kernels import _build, ops

    if ops.checked_device(device).type == "cuda":
        _build.load()


def sync(device) -> None:
    """End a timed window: wait for the card's queued work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass(frozen=True)
class Deployment:
    """The datapath shape of full mode, once for every bench: a 512-byte
    header block and a 32 KiB payload a message, in 4 KiB pages, over a
    resident pool of chip_smoke.py's 128 MiB a stack. The header stays
    well inside the parser's 256-token lookahead, also with the kTLS
    record header (ROADMAP section 3: past it, hw-kTLS forwards a tag that
    does not verify)."""
    n_shards: int = 4
    pages_per_shard: int = 8192     # 32768 pages + scratch: 128 MiB int32
    page: int = 1024                # 4 KiB of int32 tokens
    meta: int = 128                 # 512 bytes
    payload: int = 8192             # 32 KiB

    @property
    def pages(self) -> int:
        return self.n_shards * self.pages_per_shard

    @property
    def stack_kw(self) -> dict:
        return dict(n_shards=self.n_shards,
                    pages_per_shard=self.pages_per_shard,
                    page_size=self.page)


DEPLOYMENT = Deployment()


def proxy_model(page_size: int = 8, device="cuda"):
    """``(cfg, model, params)`` of ``libra-proxy-125m``: the reduced config
    under smoke (what the reference always serves), the full one (12
    layers, d_model 768, 12 heads of 64, vocabulary 32000) otherwise;
    parameters from ``init_params(0)`` on ``device``."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models.registry import build_model

    cfg = (get_reduced if is_smoke() else get_config)("libra-proxy-125m")
    model = build_model(cfg, page_size=page_size)
    return cfg, model, model.init_params(0, device=device)


# -- stream-level (socket facade) workloads ----------------------------------

BUILDERS = {
    "length-prefixed": build_message,
    "delimiter": build_delimited_message,
    "chunked": lambda m, p: build_chunked_message(
        [p[i : i + 64] for i in range(0, len(p), 64)]),
}


def stream_stack(pages: int = 4096, page_size: int = 16,
                 device_pool: bool = True, device="cuda") -> LibraStack:
    return LibraStack(n_shards=4, pages_per_shard=pages // 4,
                      page_size=page_size, secret=b"bench",
                      device_pool=device_pool, device=device)


def run_stream(*, pages: int = 8192, page_size: int = 16,
               device_pool: bool = True, device="cuda",
               **load_kw) -> Tuple[LibraStack, ProxyRuntime, int, float]:
    """Build a stack, pre-load a proxy workload (see :func:`load_proxy`),
    time a full run (ended by :func:`sync`), shut down, and assert the
    pool drained. The shared measurement loop of every stream-level
    bench; the message count is ``n_conns * n_msgs``, the application
    workload."""
    stack = stream_stack(pages=pages, page_size=page_size,
                         device_pool=device_pool, device=device)
    rt = load_proxy(stack, **load_kw)
    t0 = time.perf_counter()
    rt.run()
    sync(device)
    dt = time.perf_counter() - t0
    rt.shutdown()
    assert stack.alloc.free_pages == stack.alloc.total_pages
    return stack, rt, load_kw["n_conns"] * load_kw["n_msgs"], dt


def stream_kw() -> dict:
    """:func:`run_stream`'s pool, page and header: the reference's
    defaults under smoke, :data:`DEPLOYMENT`'s otherwise."""
    if is_smoke():
        return {}
    return dict(pages=DEPLOYMENT.pages, page_size=DEPLOYMENT.page,
                meta=DEPLOYMENT.meta)


def load_proxy(stack: LibraStack, *, n_conns: int, n_msgs: int,
               payload: int, meta: int = 8, parsers: Optional[List[str]] = None,
               budget: Optional[int] = None, selective: bool = True,
               seed: int = 0, batched: bool = False,
               batch_impl: str = "host") -> ProxyRuntime:
    """An N-connection proxy over ``stack`` with its ingress queues
    pre-loaded through the socket facade. ``selective=False`` sends every
    message down the native full-copy path (the standard-stack baseline)
    via the admission threshold; ``batched=True`` serves each round with
    one ``recv_batch``/``forward_batch`` pass."""
    rng = np.random.default_rng(seed)
    parsers = parsers or ["length-prefixed"]
    rt = ProxyRuntime(stack, tick_every=32, batched=batched,
                      batch_impl=batch_impl)
    min_payload = 8 if selective else 1 << 30
    for i in range(n_conns):
        proto = parsers[i % len(parsers)]
        src = stack.socket(proto, min_payload=min_payload)
        dst = stack.socket(proto, min_payload=min_payload)
        rt.channel(src, dst, budget=budget, name=f"{proto}-{i}")
        for _ in range(n_msgs):
            m = rng.integers(100, 200, meta)
            p = rng.integers(1000, 2000, payload)
            src.deliver(BUILDERS[proto](m, p))
    return rt


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 3,
            device="cuda") -> float:
    for _ in range(warmup):
        fn(*args)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    sync(device)
    return (time.perf_counter() - t0) / iters


def run_engine(cls, model, params, prompts, gen, device="cuda", **kw):
    eng = cls(model, params, device=device, **kw)
    for p in prompts:
        eng.submit(p, max_new_tokens=gen)
    t0 = time.perf_counter()
    eng.run()
    sync(device)
    dt = time.perf_counter() - t0
    return eng, dt


def prompts_for(vocab: int, n: int, length: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab - 1, length) for _ in range(n)]


# -- machine-readable trajectory artifacts (BENCH_<name>.json) ---------------

_ARTIFACT_ROWS: List[dict] = []


def record(name: str, **fields) -> None:
    """Add a structured result row for the running bench; every
    :func:`csv` line is recorded too."""
    _ARTIFACT_ROWS.append({"name": name, **fields})


def counters_fields(stack) -> Dict[str, int]:
    """The CopyCounters snapshot and pool transfer telemetry of a stack as
    flat JSON-friendly fields (for :func:`record`)."""
    c = stack.counters
    out = {"meta_copied": c.meta_copied, "full_copied": c.full_copied,
           "anchored": c.anchored, "zero_copied": c.zero_copied,
           "vpi_injected": c.vpi_injected, "allocs": c.allocs,
           "crypto_copied": c.crypto_copied,
           "device_fallbacks": c.device_fallbacks,
           "cross_worker_grants": c.cross_worker_grants,
           "cross_worker_copied": c.cross_worker_copied}
    out.update({f"xfer_{k}": v for k, v in stack.pool.xfer.items()})
    return out


def flush_artifact(bench: str, out_dir: str = OUT_DIR) -> Optional[str]:
    """Write (and clear) the collected rows as ``BENCH_<bench>.json``.
    Returns the path, or None when the bench recorded nothing."""
    global _ARTIFACT_ROWS
    rows, _ARTIFACT_ROWS = _ARTIFACT_ROWS, []
    if not rows:
        return None
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"BENCH_{bench}.json")
    with open(path, "w") as f:
        json.dump({"bench": bench, "unix_time": time.time(),
                   "smoke": is_smoke(), "rows": rows},
                  f, indent=1, default=str)
    return path


def csv(name: str, us: float, derived: str) -> None:
    print(f"{name},{us:.1f},{derived}")
    record(name, us_per_call=float(us), derived=derived)


# -- rows without what the clock decides --------------------------------------

#: the deliberate differences of the port's ``xfer`` (ROADMAP section 3):
#: every device round keeps its pool's storage, and no batched round is
#: gathered on the host
XFER_DIFFERENCES = ("xfer_donated_rounds", "xfer_host_gathers")

_TIMED = re.compile(
    r"(_dt|_s|_us|_ms|_per_s)$|speedup|slowdown|ratio|_over_|^tok/s$")


def _timed(key: str) -> bool:
    return key == "us_per_call" or bool(_TIMED.search(key))


def _untimed_token(tok: str) -> bool:
    key, eq, _ = tok.partition("=")
    return not (eq and (_timed(key) or key == "impl"))


def untimed(row: dict) -> dict:
    """``row`` less every field the wall clock decides (``us_per_call``,
    ``msgs_per_s``, ``rounds_per_s``, ``*_dt``, ``*_s``, ``*_us``,
    ``*_ms``, speedups, slowdowns and ratios, and the timed ``k=v`` pairs
    of ``derived``), less the ``impl`` strings (the reference's ``ref`` and
    ``fused-round:ref`` are the port's ``auto`` and ``fused-round``) and
    the deliberate ``xfer`` differences :data:`XFER_DIFFERENCES`.
    Everything else (counts, counters, identity flags) stays."""
    out = {}
    for k, v in row.items():
        if _timed(k) or k == "impl" or k in XFER_DIFFERENCES:
            continue
        if k == "derived":
            v = " ".join(t for t in v.split() if _untimed_token(t))
        out[k] = v
    return out
