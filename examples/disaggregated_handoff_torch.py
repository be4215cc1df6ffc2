"""Disaggregated prefill/decode with zero-copy KV handoff, on the PyTorch
port (``repro_torch``).

Production serving increasingly splits prefill and decode onto separate
workers. With Libra's anchored pool, the handoff is a VPI ownership
transfer (block-table metadata, O(pages) ints) — the KV payload itself
never moves. This example runs prefill on one engine "worker", transfers
the handles, and decodes on a second worker sharing the stack and the
pool, verifying tokens match a monolithic engine bit-for-bit. It prints
the lines ``examples/disaggregated_handoff.py`` prints.

  python examples/disaggregated_handoff_torch.py              # on a GPU
  PYTHONPATH=src python examples/disaggregated_handoff_torch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import LibraStack  # noqa: E402
from repro_torch.kernels.ops import checked_device  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.engine import LibraEngine  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = checked_device(ap.parse_args(argv).device)
    cfg = get_reduced("libra-proxy-125m")
    model = build_model(cfg, page_size=8)
    params = model.init_params(0, device=device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size - 1, 24) for _ in range(3)]

    # ---- monolithic reference -----------------------------------------------
    mono = LibraEngine(model, params, max_batch=3, max_len=64, page_size=8,
                       device=device)
    refs = [mono.submit(p, max_new_tokens=6) for p in prompts]
    mono.run()

    # ---- disaggregated: both workers share one LibraStack (one anchored
    # pool, one VPI registry, one tick clock) — the handoff stays in-kernel
    stack = LibraStack(n_shards=1, pages_per_shard=3 * (64 // 8 + 2) + 4,
                       page_size=8, device=device)
    prefill_worker = LibraEngine(model, params, max_batch=3, max_len=64,
                                 page_size=8, stack=stack, device=device)
    reqs = [prefill_worker.submit(p, max_new_tokens=6) for p in prompts]
    prefill_worker.step()   # prefill + first token; payload KV now anchored

    # ---- handoff: VPIs + pool ownership move; payload bytes do not -----------
    meta_moved = 0
    decode_worker = LibraEngine.__new__(LibraEngine)
    decode_worker.__dict__.update(prefill_worker.__dict__)  # shared pool
    for r in reqs:
        h = prefill_worker.forward_handle(r)
        meta_moved += len(h.pages) * 12  # (shard, pid, base) int32 triplets
        prefill_worker.release_handle(h)  # decode worker holds the other ref

    # ---- decode worker finishes the streams ----------------------------------
    decode_worker.run()

    for r, ref in zip(reqs, refs):
        if r.output != ref.output:
            raise SystemExit(f"handoff outputs differ from monolithic "
                             f"serving: {r.output} vs {ref.output}")
    kv_bytes = prefill_worker.stats.anchored_bytes
    print("handoff verified: outputs bit-identical to monolithic serving")
    print(f"KV anchored: {kv_bytes/1e6:.2f} MB; handoff metadata moved: "
          f"{meta_moved} B ({kv_bytes/max(meta_moved,1):.0f}x reduction vs "
          f"moving the payload)")
    print(f"zero-copy forwarded: "
          f"{prefill_worker.stats.zero_copy_bytes/1e6:.2f} MB")


if __name__ == "__main__":
    main()
