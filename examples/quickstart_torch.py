"""Quickstart on the PyTorch port (``repro_torch``): the Libra socket API
in five lines, then a tiny LM trained briefly and served through the Libra
engine. It prints the lines ``examples/quickstart.py`` prints.

  python examples/quickstart_torch.py                        # on a GPU
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import LibraStack, build_message  # noqa: E402
from repro_torch.core.parser import TokenStreamParser  # noqa: E402
from repro_torch.data.pipeline import DataPipeline, SyntheticCorpus  # noqa: E402
from repro_torch.kernels.ops import checked_device  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.engine import LibraEngine, StandardEngine  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402
from repro_torch.training.train_loop import Trainer  # noqa: E402


def socket_quickstart(device) -> None:
    # ---- 0. the POSIX-shaped core API ---------------------------------------
    # one stack = one Libra "kernel"; sockets hide all pool/registry plumbing
    stack = LibraStack(device=device)
    client, backend = stack.socket_pair("length-prefixed")
    msg = build_message(np.arange(4), np.arange(1000, 1064))  # 4 meta + 64 payload
    client.deliver(msg)                       # network hands bytes to the NIC
    buf, n = client.recv(1 << 16)             # proxy sees [meta..., VPI]
    client.forward(backend, buf)              # payload moves by ownership, not copy
    c = stack.counters
    print(f"socket demo: recv'd {n} logical tokens via a {len(buf)}-token "
          f"buffer; user-boundary copies={c.total_user_copies()} "
          f"zero-copied={c.zero_copied}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    device = checked_device(args.device)
    socket_quickstart(device)

    # ---- 1. build a model from a config ------------------------------------
    cfg = get_reduced("libra-proxy-125m")
    model = build_model(cfg, page_size=8)
    print(f"model: {cfg.name} ({model.param_count()/1e6:.2f}M params)")

    # ---- 2. train briefly ---------------------------------------------------
    pipe = DataPipeline(SyntheticCorpus(cfg.vocab_size, seed=0), batch=4,
                        seq_len=32)
    trainer = Trainer(model, AdamWConfig(lr=3e-3, warmup_steps=5,
                                         total_steps=args.steps), pipe,
                      device=device)
    hist = trainer.train(args.steps)
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")

    # ---- 3. serve with selective copy ---------------------------------------
    # the parser policy marks the first 4 tokens as routing metadata; the
    # rest of each prompt is opaque payload whose KV is anchored on device.
    parser = TokenStreamParser(header_len=4)
    eng = LibraEngine(model, trainer.params, max_batch=4, max_len=64,
                      page_size=8, parser=parser, device=device)
    rng = np.random.default_rng(0)
    for _ in range(6):
        eng.submit(rng.integers(1, cfg.vocab_size - 1, 20), max_new_tokens=8)
    done = eng.run()
    print(f"served {len(done)} requests; example output: {done[0].output}")
    s = eng.stats
    print(f"host-boundary traffic: {s.d2h_bytes} B down "
          f"({s.d2h_calls} transfers), {s.h2d_bytes} B up")
    print(f"payload anchored on device: {s.anchored_bytes/1e6:.2f} MB "
          f"(copied across the boundary: 0 MB)")
    print(f"engine stack counters (tokens): {eng.stack.counters}")

    # the standard stack for contrast
    std = StandardEngine(model, trainer.params, max_batch=4, max_len=64,
                         device=device)
    for _ in range(6):
        std.submit(rng.integers(1, cfg.vocab_size - 1, 20), max_new_tokens=8)
    std.run()
    print(f"standard stack: {std.stats.d2h_bytes} B down, "
          f"{std.stats.payload_copy_bytes/1e6:.2f} MB payload copies")


if __name__ == "__main__":
    main()
