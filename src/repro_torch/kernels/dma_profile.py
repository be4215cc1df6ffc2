"""DMA-vs-compute profiler for the one-kernel scheduling round.

``fused_round`` walks its page tiles through a ring of shared-memory slots
in each block: the copies of a task go out ``depth - 1`` tasks ahead of
its compute (``n_buffers`` is the depth; 0 takes the kernel's default,
``DEFAULT_FUSED_DEPTH`` in :mod:`repro_torch.kernels.selective_copy`).
Whether a deeper ring wins depends on how many tasks a block takes and on
the copy-to-compute ratio of the deployment's shape, so the depth is
measured, not assumed:

* :func:`profile_fused_depths` -- time the fused round at each candidate
  depth on one seeded operand bundle (``testing.fused_round_case``, the
  shapes the parity checks run), every operand resident on ``device``,
  warm-up excluded. Each :class:`DepthProfile` carries the wall time of a
  round (the host clock around the call and a device sync, so it includes
  the launch), the kernel's own time from CUDA events (on a CUDA device),
  and the ring depth the argument runs at: 0 and 2 launch the same ring.
* :func:`dma_compute_profile` -- one round split into its transfer leg
  and its compute leg, and how much of the cheaper leg the staged round
  hides.
* :func:`auto_buffer_depth` -- the selection policy: the fastest measured
  depth, with the ``LIBRA_FUSED_BUFFERS`` environment variable as an
  explicit override. Fastest is by kernel time where every depth has one:
  on the card a round's wall time is mostly its launch and sync, which
  the depth does not change. The result is what
  ``DevicePool.fused_buffers`` is set to.

``impl`` is one of ``'ref'``, ``'cuda'`` and ``'auto'``
(:mod:`repro_torch.kernels.ops`); ``device`` defaults to the card. On the
CPU (``device="cpu"``) the plain version runs and every depth computes the
same thing, which is what the tests use. Results feed
``benchmarks_torch/bench_dma_overlap.py``.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops, testing
from repro_torch.kernels.selective_copy import ring_depth

#: candidate ring depths: the default, double- and quad-buffered
DEFAULT_DEPTHS: Tuple[int, ...] = (0, 2, 4)
#: operands dropped from the bundle for a plaintext round
_KEYSTREAMS = ("keystream", "tx_keystream", "meta_ks")
#: a spin kernel's cycles ahead of an event-timed launch (~0.5 ms on an
#: H100), so the host's enqueue of the launch is not counted
_SPIN_CYCLES = 1_000_000


@dataclass
class DepthProfile:
    """Measured cost of one fused round at one staging depth."""
    depth: int            # the n_buffers argument
    ring_depth: int       # ring slots the kernel runs at for ``depth``
    round_s: float        # best-of-iters wall time per round
    rounds_per_s: float
    kernel_s: Optional[float] = None   # best-of-iters CUDA-event time


def _case(b: int, page: int, pps: int, meta_max: int, seed: int,
          keystreams: bool = True) -> Dict:
    """The seeded operand bundle as numpy arrays (plaintext: no RX, TX or
    metadata keystream)."""
    rng = np.random.default_rng(seed)
    case = testing.fused_round_case(rng, b=b, page=page, pps=pps,
                                    meta_max=meta_max)
    if not keystreams:
        for k in _KEYSTREAMS:
            case[k] = None
    return case


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run(case: Dict, *, meta_max: int, n_buffers: int, impl: str,
         sync: bool = True):
    """One fused round on ``case``'s tensors, waited for unless ``sync``
    is False."""
    got = ops.fused_round(
        case["stream"], case["meta_len"], case["total_len"], case["pool"],
        case["tables"], meta_max=meta_max, impl=impl, n_buffers=n_buffers,
        keystream=case["keystream"], tx_keystream=case["tx_keystream"],
        cond_off=case["cond_off"], cond_lo=case["cond_lo"],
        cond_hi=case["cond_hi"], live=case["live"], meta_ks=case["meta_ks"])
    if sync:
        _sync(case["pool"].device)
    return got


def _best(fn: Callable[[], object], iters: int, warmup: int) -> float:
    """Best of ``iters`` host-clock times of ``fn`` after ``warmup``
    calls (min: the round is deterministic, the noise is the host's)."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _best_kernel_s(fn: Callable[[], object], iters: int) -> float:
    """Best of ``iters`` CUDA-event times of ``fn``'s launch (``fn`` must
    not wait on the device), a spin kernel holding the stream while the
    host enqueues it."""
    best = float("inf")
    for _ in range(iters):
        torch.cuda._sleep(_SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / 1e3)
    return best


def profile_fused_depths(*, b: int = 8, page: int = 16, pps: int = 4,
                         meta_max: int = 16,
                         depths: Sequence[int] = DEFAULT_DEPTHS,
                         iters: int = 5, warmup: int = 2,
                         impl: str = "auto", device="cuda",
                         keystreams: bool = True,
                         seed: int = 0) -> Dict[int, DepthProfile]:
    """Time the full-operand fused round at each candidate depth.

    Warm-up rounds absorb the kernels' build and first launch; the
    reported figures are the best of ``iters`` timed rounds. A depth whose
    ring does not fit the card's shared memory raises (``ValueError``
    from the wrapper), as do 1 and negative depths: no depth is skipped."""
    dev = ops.checked_device(device)
    case = testing.to_torch(_case(b, page, pps, meta_max, seed, keystreams),
                            dev)
    out: Dict[int, DepthProfile] = {}
    for d in depths:
        def call(d=d, sync=True):
            return _run(case, meta_max=meta_max, n_buffers=d, impl=impl,
                        sync=sync)

        best = _best(call, iters, warmup)
        kernel_s = None
        if ops.resolve(impl, case["pool"]) == "cuda":
            kernel_s = _best_kernel_s(lambda: call(sync=False), iters)
        out[d] = DepthProfile(depth=d, ring_depth=ring_depth(d),
                              round_s=best,
                              rounds_per_s=1.0 / max(best, 1e-12),
                              kernel_s=kernel_s)
    return out


def dma_compute_profile(*, b: int = 8, page: int = 16, pps: int = 4,
                        meta_max: int = 16, iters: int = 5, warmup: int = 2,
                        n_buffers: int = 2, impl: str = "auto",
                        device="cuda", keystreams: bool = True,
                        seed: int = 0) -> Dict[str, float]:
    """One staged round split into its transfer and compute legs.

    * ``transfer_s`` -- a pageable host-to-device copy of the stream and
      the RX keystream, born as numpy: the bytes the ring stages tile by
      tile inside the kernel.
    * ``compute_s`` -- the round at ``n_buffers=0`` with every operand
      already resident on ``device``.
    * ``fused_s`` -- the round's operands uploaded from numpy (the pool
      stays resident) and the round at ``n_buffers``, as
      ``DevicePool.fused_round_device`` runs it.
    * ``overlap_ratio`` -- ``(transfer_s + compute_s - fused_s) /
      min(transfer_s, compute_s)``, clamped to [0, 1]: the share of the
      cheaper leg the staged round hid. The upload and the launch are
      ordered on one stream, so a ratio near 0 is expected.

    Every time is the best of ``iters`` after ``warmup``, each call waited
    for on the device."""
    dev = ops.checked_device(device)
    case = _case(b, page, pps, meta_max, seed, keystreams)
    staged = [a for a in (case["stream"], case["keystream"])
              if a is not None]

    def transfer():
        for a in staged:
            torch.from_numpy(a).to(dev)
        _sync(dev)

    resident = testing.to_torch(case, dev)

    def upload_and_run():
        up = testing.to_torch({k: v for k, v in case.items()
                               if k != "pool"}, dev)
        up["pool"] = resident["pool"]
        return _run(up, meta_max=meta_max, n_buffers=n_buffers, impl=impl)

    transfer_s = _best(transfer, iters, warmup)
    compute_s = _best(lambda: _run(resident, meta_max=meta_max, n_buffers=0,
                                   impl=impl), iters, warmup)
    fused_s = _best(upload_and_run, iters, warmup)
    hidden = transfer_s + compute_s - fused_s
    overlap = hidden / max(min(transfer_s, compute_s), 1e-12)
    return {"transfer_s": transfer_s, "compute_s": compute_s,
            "fused_s": fused_s,
            "overlap_ratio": float(np.clip(overlap, 0.0, 1.0))}


def auto_buffer_depth(*, b: int = 8, page: int = 16, pps: int = 4,
                      meta_max: int = 16,
                      depths: Sequence[int] = DEFAULT_DEPTHS,
                      iters: int = 3, warmup: int = 1,
                      impl: str = "auto", device="cuda", seed: int = 0,
                      profiles: Optional[Dict[int, DepthProfile]] = None,
                      ) -> int:
    """The staging depth the fused datapath should run with.

    ``LIBRA_FUSED_BUFFERS`` overrides (0 for the default depth, 2 and up
    to pin a ring depth; anything else raises ``ValueError``); otherwise
    the fastest measured depth wins: the least ``kernel_s`` when every
    profile has one (a CUDA device), else the least ``round_s``. Pass
    ``profiles`` to reuse an existing :func:`profile_fused_depths` sweep
    instead of measuring again."""
    env = os.environ.get("LIBRA_FUSED_BUFFERS", "")
    if env:
        depth = int(env)
        if not (depth == 0 or depth >= 2):
            raise ValueError(f"LIBRA_FUSED_BUFFERS={depth}: expected 0 or "
                             "a ring depth >= 2")
        return depth
    if profiles is None:
        profiles = profile_fused_depths(
            b=b, page=page, pps=pps, meta_max=meta_max, depths=depths,
            iters=iters, warmup=warmup, impl=impl, device=device, seed=seed)
    timed = all(p.kernel_s is not None for p in profiles.values())
    return min(profiles.values(),
               key=lambda p: p.kernel_s if timed else p.round_s).depth
