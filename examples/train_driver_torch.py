"""End-to-end training driver on the PyTorch port (``repro_torch``): train
a small LM with checkpointing, a simulated preemption and a resume by a
new trainer -- the fault-tolerant loop of ``examples/train_driver.py``,
with its lines.

  python examples/train_driver_torch.py --full           # 125M, on a GPU
  PYTHONPATH=src python examples/train_driver_torch.py --device cpu
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.data.pipeline import DataPipeline, SyntheticCorpus  # noqa: E402
from repro_torch.kernels.ops import checked_device  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402
from repro_torch.training.train_loop import Trainer  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="use the full 125M libra-proxy model")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: one under the "
                         "system's temporary directory)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = checked_device(args.device)

    cfg = (get_config("libra-proxy-125m") if args.full
           else get_reduced("libra-proxy-125m"))
    steps = args.steps or (200 if args.full else 120)
    model = build_model(cfg)
    print(f"training {cfg.name}: {model.param_count()/1e6:.1f}M params, "
          f"{steps} steps")

    ckpt_dir = args.ckpt or os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train_driver")
    pipe = DataPipeline(SyntheticCorpus(cfg.vocab_size, seed=0),
                        batch=2 if args.full else 8,
                        seq_len=64 if args.full else 48)
    opt = AdamWConfig(lr=1e-3 if args.full else 3e-3,
                      warmup_steps=steps // 10, total_steps=steps,
                      schedule=cfg.lr_schedule)

    trainer = Trainer(model, opt, pipe, checkpoint_dir=ckpt_dir,
                      checkpoint_every=25, device=device)
    trainer.install_signal_handlers()
    resumed = trainer.resume()
    print("resumed from checkpoint" if resumed else "fresh start")

    # phase 1: train to ~60%, then simulate a preemption
    phase1 = int(steps * 0.6) - trainer.step
    if phase1 > 0:
        trainer.train(phase1)
        print(f"[phase 1] step {trainer.step}, "
              f"loss {trainer.history[-1]['loss']:.3f}")
        trainer._preempted = True   # simulated SIGTERM
        trainer.train(1)            # triggers the final checkpoint
        print(f"[preempted] checkpoint at step {trainer.ckpt.latest_step()}")

    # phase 2: a "new job" resumes and finishes
    trainer2 = Trainer(model, opt, pipe, checkpoint_dir=ckpt_dir,
                       checkpoint_every=25, device=device)
    if not trainer2.resume():
        raise RuntimeError(f"no checkpoint to resume from in {ckpt_dir}")
    print(f"[phase 2] resumed at step {trainer2.step}")
    trainer2.train(steps - trainer2.step)
    hist = trainer2.history
    print(f"[done] step {trainer2.step}  loss "
          f"{hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}  "
          f"stragglers flagged: {trainer2.straggler_events}")


if __name__ == "__main__":
    main()
