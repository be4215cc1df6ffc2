"""Optimizers & LR schedules: AdamW with decoupled weight decay and
global-norm clipping; cosine, MiniCPM's warmup-stable-decay (WSD) and
constant schedules.

PyTorch twin of the JAX package's ``repro.training.optimizer``. The
moments are float32 and the update is computed in float32, in the
reference's order of operations. One difference, deliberate: the JAX
update returns new trees (its jitted step donates the old ones), while
:func:`adamw_update` writes the parameters and both moments in place and
returns them. A model at full width then needs no second copy of its
parameters and moments at the step (16 bytes a parameter, not 28).

``compressed_psum`` is the reference's int8 gradient reduction with
error feedback across a process group (a mesh axis's,
``DeviceMesh.get_group``), over ``quantize_int8`` / ``dequantize_int8``.

The parameters and moments may be DTensors (``Trainer(mesh=...)``): the
moments are made ``zeros_like`` their parameters, so they take the
parameters' placements, and every update is elementwise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.layers import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # scalar int32
    mu: Any              # first moment (nested dict, float32)
    nu: Any              # second moment (nested dict, float32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"     # cosine | wsd | constant
    warmup_steps: int = 100
    total_steps: int = 10000
    # WSD: fraction of total steps spent in the final decay phase
    wsd_decay_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), a
    float32 tensor on the step's device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))
    if cfg.schedule == "wsd":
        # warmup -> stable plateau -> sqrt-style decay tail (MiniCPM)
        decay_start = 1.0 - cfg.wsd_decay_frac
        tail = torch.clamp((t - decay_start) / cfg.wsd_decay_frac, 0.0, 1.0)
        return cfg.lr * warm * torch.where(t < decay_start, 1.0, 1.0 - tail)
    raise ValueError(cfg.schedule)


def init_adamw(params) -> AdamWState:
    """Zero moments shaped like ``params``, on their devices (and, for
    DTensors, with their placements), and step 0."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      tree_map(zeros, params), tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree`` together, in float32."""
    norms = [torch.linalg.vector_norm(g.float()) for g in tree_leaves(tree)]
    return torch.stack(norms).square().sum().sqrt()


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: AdamWState
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step: the gradients clipped to a global norm of
    ``grad_clip``, both moments updated, bias corrected, and the update
    plus ``weight_decay * p`` scaled by the schedule's rate. ``params``
    (float32, as the trainer keeps them), ``state.mu`` and ``state.nu`` are
    written in place and returned, with the metrics ``{"grad_norm",
    "lr"}`` as float32 tensors; ``grads`` are read only."""
    gnorm = global_norm(grads)
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1.0 - torch.pow(cfg.b2, step.to(torch.float32))

    def upd(p, g, m, v):
        if p.dtype != torch.float32:
            raise TypeError(f"adamw_update keeps float32 parameters, not "
                            f"{p.dtype}")
        g = g.float() * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        denom = torch.div(v, b2c).sqrt_().add_(cfg.eps)
        delta = torch.div(m, b1c).div_(denom)
        del denom
        delta.add_(p, alpha=cfg.weight_decay)
        p.sub_(delta.mul_(lr))

    tree_map(upd, params, grads, state.mu, state.nu)
    return params, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# gradient compression (int8 with error feedback) -- cross-pod reduction
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = x.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(grads, group, error_state):
    """int8 all-reduce with error feedback: each leaf plus its carried
    residual is quantised to int8 (one scale a leaf), the dequantised
    values are summed over ``group`` (a process group; ``None`` is the
    default group) and divided by its size, and the quantisation residual
    is returned to be carried into the next step, so the compressed
    reduction is unbiased in the long run. Used for the cross-pod (``pod``
    axis) gradient reduction, where the inter-node bandwidth is the
    bottleneck. Returns ``(mean tree, new error tree)``, float32."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    if group is None:
        group = dist.group.WORLD
    n = dist.get_world_size(group)

    def one(g, e):
        g = g.float() + e
        q, scale = quantize_int8(g)
        deq = dequantize_int8(q, scale)
        deq_sum = funcol.wait_tensor(funcol.all_reduce(deq, "sum", group))
        return deq_sum / n, g - deq   # (mean, local residual)

    out = tree_map(one, grads, error_state)
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)
