"""DMA-vs-compute overlap profile of the one-kernel scheduling round, on
the card.

Runs :mod:`repro_torch.kernels.dma_profile` at the datapath cell's round
(64 rows, pages of 1024 tokens, 16 pages a row, 256 metadata tokens; the
reference's toy shape under ``LIBRA_BENCH_SMOKE=1``) and reports, per
candidate depth, the best wall-clock round (launch and sync included),
the best CUDA-event kernel time on a CUDA device, and the ring depth the
argument runs at; then the transfer/compute split of one staged round
and the overlap ratio; and last the depth :func:`auto_buffer_depth`
selects from these profiles (the least kernel time on a CUDA device).
``--device cpu`` runs the plain version. Writes
``results/bench_torch/BENCH_dma_overlap.json`` (or ``--out``)::

    PYTHONPATH=src python -m benchmarks_torch.bench_dma_overlap
    PYTHONPATH=src LIBRA_BENCH_SMOKE=1 python -m \\
        benchmarks_torch.bench_dma_overlap --device cpu
"""
from __future__ import annotations

import argparse
import subprocess
from typing import Optional, Sequence

from benchmarks_torch.common import OUT_DIR, csv, flush_artifact, is_smoke, \
    record
from repro_torch.kernels.dma_profile import (
    DEFAULT_DEPTHS,
    auto_buffer_depth,
    dma_compute_profile,
    profile_fused_depths,
)


def _card(device: str) -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    if not device.startswith("cuda"):
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    smoke = is_smoke()
    shape = dict(b=4, page=8, pps=2, meta_max=8) if smoke else \
        dict(b=64, page=1024, pps=16, meta_max=256)
    iters = 3 if smoke else 20
    warmup = 1 if smoke else 3
    run = dict(device=args.device)
    card = _card(args.device)

    profs = profile_fused_depths(iters=iters, warmup=warmup, **run, **shape)
    for d in DEFAULT_DEPTHS:
        p = profs[d]
        kernel_us = None if p.kernel_s is None else p.kernel_s * 1e6
        csv(f"dma_overlap_depth{d}", p.round_s * 1e6,
            f"rounds_per_s={p.rounds_per_s:.0f} n_buffers={d} "
            f"ring_depth={p.ring_depth} kernel_us={kernel_us}")
        record(f"dma_overlap_depth{d}_series", n_buffers=d,
               ring_depth=p.ring_depth, rounds_per_s=p.rounds_per_s,
               round_us=p.round_s * 1e6, kernel_us=kernel_us, card=card,
               **run, **shape)

    decomp = dma_compute_profile(iters=iters, warmup=warmup, n_buffers=2,
                                 **run, **shape)
    csv("dma_overlap_decomposition", decomp["fused_s"] * 1e6,
        f"transfer_us={decomp['transfer_s'] * 1e6:.1f} "
        f"compute_us={decomp['compute_s'] * 1e6:.1f} "
        f"overlap_ratio={decomp['overlap_ratio']:.2f}")
    record("dma_overlap_decomposition_series",
           overlap_ratio=decomp["overlap_ratio"],
           transfer_us=decomp["transfer_s"] * 1e6,
           compute_us=decomp["compute_s"] * 1e6,
           fused_us=decomp["fused_s"] * 1e6, card=card, **run, **shape)

    depth = auto_buffer_depth(profiles=profs)
    csv("dma_overlap_selected", 0.0,
        f"auto_depth={depth} "
        f"candidates={'/'.join(str(d) for d in DEFAULT_DEPTHS)}")
    record("dma_overlap_selected_series", auto_depth=depth, card=card)
    print(flush_artifact("dma_overlap", args.out))


if __name__ == "__main__":
    main()
