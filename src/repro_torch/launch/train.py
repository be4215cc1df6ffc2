"""Training launcher of the port, the JAX package's
``repro.launch.train`` with the same flags and ``--device``.

Local run (reduced config, CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
      --reduced --steps 100 --batch 8 --seq 128 --ckpt ckpt \
      --device cpu

On the card (the default ``--device cuda``, which raises without a GPU):
  PYTHONPATH=src python -m repro_torch.launch.train --steps 30

The reference's ``--mesh`` runs go through its dry-run tooling, which
waits for the port's device mesh (``ROADMAP.md``, queue 1, item 5); this
launcher trains on one device. Resume is automatic from ``--ckpt`` with
``--resume``.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

import torch

from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.data.pipeline import DataPipeline, SyntheticCorpus
from repro_torch.kernels.ops import checked_device
from repro_torch.models.layers import REMAT
from repro_torch.models.registry import build_model
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import Trainer


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="libra-proxy-125m",
                    choices=ARCHS + ["libra-proxy-125m"])
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--remat", default="none", choices=list(REMAT))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log", default=None, help="write history JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    device = checked_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg)
    devices = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"arch={cfg.name} params={model.param_count()/1e6:.1f}M "
          f"devices={devices}")

    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    pipe = DataPipeline(corpus, batch=args.batch, seq_len=args.seq)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps,
                      schedule=cfg.lr_schedule)
    trainer = Trainer(model, opt, pipe, checkpoint_dir=args.ckpt,
                      checkpoint_every=args.ckpt_every, remat=args.remat,
                      device=device)
    trainer.install_signal_handlers()
    if args.resume and trainer.resume():
        print(f"resumed from step {trainer.step}")

    hist = trainer.train(args.steps - trainer.step)
    for h in hist[:: max(len(hist) // 20, 1)]:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} lr {h['lr']:.2e} "
              f"({h['time']*1000:.0f} ms)")
    if hist:
        print(f"final loss {hist[-1]['loss']:.4f}; "
              f"stragglers flagged: {trainer.straggler_events}")
    if args.log:
        with open(args.log, "w") as f:
            json.dump(hist, f)
    return hist


if __name__ == "__main__":
    main()
