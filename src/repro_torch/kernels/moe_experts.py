"""Python wrappers of the serving paths' dropless MoE layer on the card
(``csrc/moe_experts.cu``): :func:`moe_route` makes the layer's entries
(top-k, the shared expert's blocks, sorted by group, rows gathered) in one
call, and :func:`moe_experts` runs every entry's SwiGLU expert in one
launch, split-TF32, float32 accuracy, over groups whose bounds stay on the
device.

Each wrapper takes float32 CUDA tensors only (``offsets`` int32): it checks
device, dtype, shapes, contiguity and the 16-byte alignment and widths that
the kernel's TMA loads need (``D`` and ``F`` multiples of 4), allocates the
outputs and the kernels' scratch with ``torch.empty``, launches on
``torch.cuda.current_stream()`` and raises if the launch is refused. They
read nothing back: the groups' sizes are the kernels' to read. Neither
falls back to the plain version;
:mod:`repro_torch.kernels.ops` picks between the two by the tensors'
device. :data:`LAUNCHES` counts the launches. The routing kernels also
note, in a ring on the device, how many routed experts each call's entries
reach (the experts whose weights the experts kernel then reads):
:func:`experts_reached` reads the last ones back, for a roofline's bytes.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.kernels import _build

#: launches since the last :func:`reset_launches`
LAUNCHES = {"moe_experts": 0, "moe_route": 0}
#: the most groups (routed experts and shared blocks) a launch takes
MAX_GROUPS = 256
#: rows of the kernel's tiles (the counters are one a row tile)
TILE_ROWS = 128
#: the routing calls whose reached experts the ring on each device keeps
RING = 1 << 16
_REACHED: Dict[torch.device, torch.Tensor] = {}

F32 = torch.float32
_check = _build.check_tensor


def reset_launches() -> None:
    _build.reset_counts(LAUNCHES)


def _ring(dev: torch.device) -> torch.Tensor:
    """The device's ring: ``RING`` counts and, last, the calls noted."""
    ring = _REACHED.get(dev)
    if ring is None:
        ring = _REACHED[dev] = torch.zeros((RING + 1,), dtype=torch.int32,
                                           device=dev)
    return ring


def experts_reached(n: int, dev: Optional[torch.device] = None
                    ) -> Optional[List[int]]:
    """The routed experts that each of the last ``n`` routing calls on
    ``dev`` (the current CUDA device by default) reached, oldest first, or
    ``None`` where the ring does not hold ``n`` calls. Waits for the
    device."""
    if dev is None:
        if not torch.cuda.is_available():
            return None
        dev = torch.device("cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ring = _REACHED.get(dev)
    if ring is None or not 0 <= n <= RING:
        return None
    host = ring.cpu().tolist()
    calls = host[RING] % 2 ** 32
    if calls < n:
        return None
    return [host[(calls - n + i) % RING] for i in range(n)]


def moe_experts(xs: torch.Tensor, offsets: torch.Tensor, gates: torch.Tensor,
                dest: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor,
                shared_gate: Optional[torch.Tensor] = None,
                shared_up: Optional[torch.Tensor] = None,
                shared_down: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y [N, D]`` of ``ref.moe_experts_ref`` (its docstring states the
    operands); rows from ``offsets[-1]`` on are left unwritten."""
    if xs.dim() != 2 or w_gate.dim() != 3:
        raise ValueError(f"moe_experts: xs {tuple(xs.shape)} must be [N, D] "
                         f"and w_gate {tuple(w_gate.shape)} [E, D, F]")
    n, d = xs.shape
    e, _, f = w_gate.shape
    shared = shared_gate is not None
    s = shared_gate.shape[-1] // f if shared else 0
    dev = xs.device
    _check("xs", xs, dtype=F32)
    _check("offsets", offsets, (e + s + 1,), dtype=torch.int32, device=dev)
    _check("gates", gates, (n,), dtype=F32, device=dev)
    _check("dest", dest, (n,), dtype=torch.int64, device=dev)
    _check("w_gate", w_gate, (e, d, f), dtype=F32, device=dev)
    _check("w_up", w_up, (e, d, f), dtype=F32, device=dev)
    _check("w_down", w_down, (e, f, d), dtype=F32, device=dev)
    if shared:
        _check("shared_gate", shared_gate, (d, s * f), dtype=F32, device=dev)
        _check("shared_up", shared_up, (d, s * f), dtype=F32, device=dev)
        _check("shared_down", shared_down, (s * f, d), dtype=F32, device=dev)
    if d % 4 or f % 4:
        raise ValueError(f"moe_experts: D {d} and F {f} must be multiples of "
                         "4 (TMA reads rows of whole 16-byte units)")
    if e + s > MAX_GROUPS:
        raise ValueError(f"moe_experts: {e + s} groups, at most {MAX_GROUPS}")
    ops = [xs, w_gate, w_up, w_down] + ([shared_gate, shared_up, shared_down]
                                         if shared else [])
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError("moe_experts: every float32 operand must start on a "
                         "16-byte boundary")
    y = torch.empty((n, d), dtype=F32, device=dev)
    if n == 0:
        return y
    h = torch.empty((n, f), dtype=F32, device=dev)
    done = torch.empty((n // TILE_ROWS + e + s,), dtype=torch.int32,
                       device=dev)
    none = 0
    _build.launch("moe_experts", dev, xs.data_ptr(), offsets.data_ptr(),
                  gates.data_ptr(), dest.data_ptr(), w_gate.data_ptr(),
                  w_up.data_ptr(),
                  w_down.data_ptr(),
                  shared_gate.data_ptr() if shared else none,
                  shared_up.data_ptr() if shared else none,
                  shared_down.data_ptr() if shared else none,
                  h.data_ptr(), y.data_ptr(), done.data_ptr(), n, d, f, e, s)
    _build.count_launch(LAUNCHES, "moe_experts")
    return y


def moe_route(logits: torch.Tensor, x: torch.Tensor,
              gate_proj: Optional[torch.Tensor], valid: Optional[torch.Tensor],
              *, num_experts: int, top_k: int, num_shared: int,
              norm_topk: bool):
    """``(xs, offsets, gates, dest)`` of ``ref.moe_route_ref`` (its
    docstring states the operands), the entries in any order within a
    group."""
    if logits.dim() != 2 or x.dim() != 2 or logits.shape[0] != x.shape[0]:
        raise ValueError(f"moe_route: logits {tuple(logits.shape)} must be "
                         f"[T, Ep] and x {tuple(x.shape)} [T, D]")
    (t, ep), d = logits.shape, x.shape[1]
    s, dev = num_shared, x.device
    _check("logits", logits, dtype=F32)
    _check("x", x, dtype=F32, device=dev)
    _check("gate_proj", gate_proj, (d, 1), dtype=F32, device=dev)
    _check("valid", valid, (t,), dtype=torch.bool, device=dev)
    if (gate_proj is None) != (s == 0):
        raise ValueError("moe_route: gate_proj goes with num_shared > 0")
    if not 0 < top_k <= num_experts <= ep <= MAX_GROUPS - s:
        raise ValueError(f"moe_route: top_k {top_k}, {num_experts} experts "
                         f"of {ep} and {s} shared blocks do not fit")
    if d % 4 or x.data_ptr() % 16:
        raise ValueError("moe_route: x's rows must be whole 16-byte units "
                         "from a 16-byte boundary")
    width = top_k + s
    n = t * width
    xs = torch.empty((n, d), dtype=F32, device=dev)
    offsets = torch.empty((ep + s + 1,), dtype=torch.int32, device=dev)
    gates = torch.empty((n,), dtype=F32, device=dev)
    dest = torch.empty((n,), dtype=torch.int64, device=dev)
    if t == 0:
        return xs, offsets.zero_(), gates, dest
    scratch = torch.empty((2 * n + 2 * (ep + s),), dtype=torch.int32,
                          device=dev)
    _build.launch("moe_route", dev, logits.data_ptr(), x.data_ptr(),
                  0 if gate_proj is None else gate_proj.data_ptr(),
                  0 if valid is None else valid.data_ptr(), xs.data_ptr(),
                  offsets.data_ptr(), gates.data_ptr(), dest.data_ptr(),
                  scratch.data_ptr(), _ring(dev).data_ptr(), t, ep,
                  num_experts, top_k, s, d, int(norm_topk), RING)
    _build.count_launch(LAUNCHES, "moe_route")
    return xs, offsets, gates, dest
