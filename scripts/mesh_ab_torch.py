"""Phase 21 (a) of ``chip_smoke.py`` on one checkout, for comparing two
checkouts on one card.

Serves ``chip_smoke.MESH_SERVE`` (phi4-mini, full) without a mesh and then
through the mesh keywords on a one-rank NCCL group and a
``(data=1, model=1)`` mesh (``chip_smoke.mesh_serve``, which checks that
the tokens are identical), using the ``chip_smoke`` and ``repro_torch`` of
the checkout at ``TREE``, and prints one ``MESH_AB`` JSON line: each run's
median wall ms a step and its profiled step (device ms by label). To
compare two checkouts, run both in one session, interleaved::

    python scripts/mesh_ab_torch.py OLD && python scripts/mesh_ab_torch.py . \\
        && python scripts/mesh_ab_torch.py . && python scripts/mesh_ab_torch.py OLD

Needs one CUDA device; builds the checkout's kernels first.
"""
import datetime
import json
import os
import socket
import sys
import time

tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
sys.path[:0] = [tree, os.path.join(tree, "src")]
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.common.sharding import make_mesh  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import attention as kattn  # noqa: E402

for mod in (cs, repro_torch):
    if not os.path.abspath(mod.__file__).startswith(tree + os.sep):
        sys.exit(f"{mod.__name__} came from {mod.__file__}, not {tree}")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
_build.build(verbose=False)
with socket.socket() as sk:
    sk.bind(("127.0.0.1", 0))
    port = sk.getsockname()[1]
dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                        rank=0, world_size=1,
                        timeout=datetime.timedelta(seconds=60))
try:
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
    t = time.perf_counter()
    out = cs.mesh_serve(cs.MESH_SERVE, mesh, dev, torch, np, kattn)
    out["seconds"] = time.perf_counter() - t
finally:
    dist.destroy_process_group()
print("MESH_AB", json.dumps({"tree": tree, "card": cs.card_line(torch),
                             **out}), flush=True)
