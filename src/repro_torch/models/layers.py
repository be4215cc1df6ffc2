"""Shared model primitives: param templates, norms, RoPE, sinusoidal
positions, MLPs, the causal depthwise conv of the xLSTM blocks, and the
training pieces every model shares (:func:`remat_call`,
:func:`masked_nll`).

PyTorch twins of the JAX package's ``repro.models.layers``. A ``ParamSpec``
template is the single source of truth per architecture: ``init_params``
(real tensors), ``abstract_params`` (meta tensors, the dry-run's),
``param_axes`` (logical sharding names) and ``count_template_params`` are
all derived from it, so they cannot diverge.
Parameters are nested dicts of tensors with the JAX package's keys and
shapes, so a JAX parameter tree carries across leaf for leaf
(:func:`repro_torch.models.convert.params_from_jax`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.common.sharding import is_distributed

Params = Any  # nested dict of tensors


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0    # stddev multiplier for 'normal' (fan-in scaled)
    fan_in_dims: Tuple[int, ...] = ()  # dims whose product is fan-in; () -> second-to-last

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


Template = Dict[str, Any]  # nested dict of ParamSpec


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` trees share the
    keys of ``tree``); keys are visited in sorted order, as ``jax.tree``
    flattens a dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def unstack(tree) -> list:
    """The per-layer trees of a tree stacked on a leading layer axis, each
    leaf a view. Each leaf is unbound once, so autograd stacks a leaf's
    layer gradients once, where a view a layer (``a[i]``) would add a
    zero-filled copy of the whole stack for every layer."""
    views = tree_map(lambda a: a.unbind(0), tree)
    n = len(tree_leaves(views)[0])
    return [tree_map(lambda t, i=i: t[i], views) for i in range(n)]


def _fan_in(spec: ParamSpec) -> int:
    if spec.init != "normal":
        return 1
    if spec.fan_in_dims:
        f = 1
        for d in spec.fan_in_dims:
            f *= spec.shape[d]
        return f
    if len(spec.shape) >= 2:
        return spec.shape[-2]
    return spec.shape[-1]


def init_params(generator: torch.Generator, template: Template, *,
                device) -> Params:
    """Random parameters for ``template`` on ``device``, drawn from
    ``generator`` (which must live on ``device``) with the JAX package's
    standard deviations (``scale / sqrt(fan_in)``), zeros and ones, in
    float32. The numbers differ from ``jax.random``'s: carry a JAX tree
    across with ``params_from_jax`` where both packages must compute the
    same thing."""
    def make(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=torch.float32, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=torch.float32, device=device)
        std = spec.scale / math.sqrt(_fan_in(spec))
        return torch.randn(spec.shape, generator=generator,
                           dtype=torch.float32, device=device).mul_(std)
    return tree_map(make, template)


def abstract_params(template: Template, dtype=torch.float32) -> Params:
    """Meta-device tensors of the template's shapes in ``dtype``: the
    counterpart of JAX's ``ShapeDtypeStruct`` tree (the dry-run's
    parameters; nothing is allocated)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), template)


def param_axes(template: Template) -> Params:
    """The logical sharding names of every parameter, leaf for leaf."""
    return tree_map(lambda s: s.axes, template)


def split_heads(x: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """``x [..., heads * head_dim] -> [..., heads, head_dim]``. A DTensor
    whose last dim is sharded over more ranks than split ``heads`` into
    whole heads is gathered along it first (GSPMD reshards such a reshape
    by itself; DTensor refuses it)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(x, DTensor):
        last = x.dim() - 1
        sizes = x.device_mesh.shape
        n = math.prod(sz for sz, pl in zip(sizes, x.placements)
                      if isinstance(pl, Shard) and pl.dim in (last, -1))
        if n > 1 and heads % n:
            x = x.redistribute(x.device_mesh, [
                Replicate() if isinstance(pl, Shard) and pl.dim in (last, -1)
                else pl for pl in x.placements])
    return x.reshape(*x.shape[:-1], heads, head_dim)


def count_template_params(template: Template) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(template))


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm scaled by ``(1 + w)``: ``w`` is initialised to zeros."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + w.float())).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm with weight ``w`` and bias ``b``; population variance,
    as ``jnp.var``."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def group_norm(x: torch.Tensor, w: torch.Tensor, num_groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """Per-head group norm used by xLSTM cells. x [..., H*dh] grouped by H;
    population variance, as ``jnp.var``."""
    dt = x.dtype
    *lead, d = x.shape
    x = x.float().reshape(*lead, num_groups, d // num_groups)
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x.reshape(*lead, d) * w.float()).to(dt)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, as ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., seq, heads, head_dim]; positions broadcastable to [..., seq].
    Rotates the split halves ``(x[:hd/2], x[hd/2:])``, not interleaved
    pairs."""
    dt = x.dtype
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)   # [hd/2]
    ang = positions[..., None].float() * freqs                # [..., seq, hd/2]
    cos = torch.cos(ang)[..., None, :]                        # [..., seq, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dt)


def sinusoidal_rows(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Rows ``positions`` of :func:`sinusoidal_positions`' table, shaped
    ``positions.shape + (d_model,)``, without building the table: each row
    depends only on its position (``sin`` at the even columns, ``cos`` at
    the odd ones). The encoder-decoder's decode step takes its rows at
    ``seq_lens`` so, where the JAX package builds ``2 ** 20`` rows a step
    and indexes them."""
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=positions.device)
                    * (-math.log(10000.0) / d_model))
    ang = positions.float()[..., None] * div
    return torch.stack([torch.sin(ang), torch.cos(ang)],
                       dim=-1).reshape(*positions.shape, d_model)


def sinusoidal_positions(length: int, d_model: int, device=None
                         ) -> torch.Tensor:
    """The ``[length, d_model]`` float32 table of sinusoidal positions."""
    return sinusoidal_rows(torch.arange(length, device=device), d_model)


# ---------------------------------------------------------------------------
# MLP blocks
# ---------------------------------------------------------------------------

def mlp_template(d_model: int, d_ff: int, act: str) -> Template:
    if act == "swiglu":
        return {
            "w_gate": ParamSpec((d_model, d_ff), ("fsdp", "tensor")),
            "w_up": ParamSpec((d_model, d_ff), ("fsdp", "tensor")),
            "w_down": ParamSpec((d_ff, d_model), ("tensor", "fsdp")),
        }
    return {
        "w_up": ParamSpec((d_model, d_ff), ("fsdp", "tensor")),
        "b_up": ParamSpec((d_ff,), ("tensor",), init="zeros"),
        "w_down": ParamSpec((d_ff, d_model), ("tensor", "fsdp")),
        "b_down": ParamSpec((d_model,), (None,), init="zeros"),
    }


def mlp_apply(p: Params, x: torch.Tensor, act: str,
              mm=torch.matmul) -> torch.Tensor:
    """The FFN of ``x``, its products taken by ``mm``."""
    if act == "swiglu":
        h = F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"])
        return mm(h, p["w_down"])
    h = gelu(mm(x, p["w_up"]) + p["b_up"])
    return mm(h, p["w_down"]) + p["b_down"]


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. x [B, S, C], w [K, C]."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):  # K is tiny (4)
        out = out + pad[:, i: i + x.shape[1], :] * w[i]
    if b is not None:
        out = out + b
    return out


def conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step of the causal conv. conv_state [B, K-1, C]."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # [B, K, C]
    dt = torch.promote_types(window.dtype, w.dtype)   # as jnp.einsum does
    out = torch.einsum("bkc,kc->bc", window.to(dt), w.to(dt))
    if b is not None:
        out = out + b
    return out, window[:, 1:, :]


# ---------------------------------------------------------------------------
# training: rematerialisation and the masked token loss
# ---------------------------------------------------------------------------

#: ``remat`` values of the models' ``forward`` / ``loss_fn``: keep every
#: activation, recompute each block in the backward, or recompute all but
#: the outputs of the plain matrix products
REMAT = ("none", "full", "dots")


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs of
    ``aten.mm`` (the products without batch dims; ``x @ w`` of a
    ``[B, S, D]`` activation folds into one), recompute everything else.
    The counterpart of ``jax.checkpoint_policies
    .checkpoint_dots_with_no_batch_dims``."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(fn: Callable, x: torch.Tensor, remat: str):
    """``fn(x)`` under the ``remat`` policy (:data:`REMAT`): ``"full"``
    and ``"dots"`` run it under ``torch.utils.checkpoint`` (non-reentrant,
    so tensors ``fn`` closes over get their gradients)."""
    if remat == "none":
        return fn(x)
    if remat == "full":
        return checkpoint(fn, x, use_reentrant=False)
    if remat == "dots":
        return checkpoint(fn, x, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _save_matmuls))
    raise ValueError(f"unknown remat {remat!r} (expected one of {REMAT})")


def masked_nll(logits: torch.Tensor, labels: torch.Tensor):
    """Mean next-token NLL of float32 ``logits [B, S, V]`` over the labels
    that are not negative. Returns ``(loss, lse [B, S], mask [B, S],
    ntok)``, the pieces the models' ``loss_fn`` combine."""
    mask = (labels >= 0).float()
    if is_distributed(logits):
        lse, gold = _lse_gold_sharded(logits, labels)
    else:
        lse, gold = _lse_gold(logits, labels)
    ntok = mask.sum().clamp(min=1.0)
    loss = ((lse - gold) * mask).sum() / ntok
    return loss, lse, mask, ntok


def _lse_gold(logits: torch.Tensor, labels: torch.Tensor):
    """Each row's log-sum-exp and its label's logit (label < 0: the first
    logit, masked out later)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    return lse, gold


def _lse_gold_sharded(logits, labels):
    """:func:`_lse_gold` of DTensor logits whose vocab may be sharded
    (``"vocab"`` over ``model``): each rank reduces its slice of the
    vocabulary and the maxima and sums are all-reduced over the vocab
    axes, the vocab-parallel cross-entropy GSPMD derives from the
    reference's ``logsumexp`` / ``take_along_axis``. Rows stay sharded as
    the logits' batch is."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.common.sharding import (
        all_reduce,
        axis_index,
        contiguous_grad,
        mesh_axis_names,
        mesh_axis_sizes,
        psum_identity_grad,
    )

    mesh = logits.device_mesh
    last = logits.dim() - 1
    names = mesh_axis_names(mesh)
    lpl = tuple(p if isinstance(p, Shard) and p.dim in (0, last, -1)
                else Replicate() for p in logits.placements)
    vocab_axes = tuple(a for a, p in zip(names, lpl)
                       if isinstance(p, Shard) and p.dim in (last, -1))
    rowpl = tuple(p if p == Shard(0) else Replicate() for p in lpl)
    sizes = mesh_axis_sizes(mesh)

    def local(lg, lb):
        lg = contiguous_grad(lg)
        if math.prod(sizes[a] for a in vocab_axes) == 1:
            return _lse_gold(lg, lb)      # the vocabulary is whole here
        vl = lg.shape[-1]
        r = 0
        for a in vocab_axes:
            r = r * sizes[a] + axis_index(mesh, a)
        m = all_reduce(lg.detach().amax(dim=-1), "max", mesh, vocab_axes)
        se = psum_identity_grad(torch.exp(lg - m[..., None]).sum(dim=-1),
                                mesh, vocab_axes)
        lse = m + torch.log(se)
        idx = lb.long().clamp(min=0) - r * vl
        mine = (idx >= 0) & (idx < vl)
        g = lg.gather(-1, idx.clamp(0, vl - 1)[..., None])[..., 0]
        gold = psum_identity_grad(torch.where(mine, g, torch.zeros_like(g)),
                                  mesh, vocab_axes)
        return lse, gold

    return local_map(local, out_placements=(list(rowpl), list(rowpl)),
                     in_placements=(lpl, rowpl),
                     device_mesh=mesh, redistribute_inputs=True)(logits,
                                                                  labels)


def argmax_last(x: torch.Tensor) -> torch.Tensor:
    """``x.argmax(dim=-1)``; a DTensor sharded along its last dim (the
    vocabulary) is gathered along it first."""
    from torch.distributed.tensor import Replicate, Shard

    if is_distributed(x):
        last = x.dim() - 1
        pl = [Replicate() if isinstance(p, Shard) and p.dim in (last, -1)
              else p for p in x.placements]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.argmax(dim=-1)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``. From a DTensor table sharded over
    its rows (the vocabulary) the rows come back partial (a masked sum);
    they are reduced here, where the lookup's mask is still at hand."""
    from torch.distributed.tensor import Partial, Replicate

    x = F.embedding(tokens.long(), table)
    if is_distributed(x) and any(isinstance(p, Partial)
                                 for p in x.placements):
        x = _ReplicatedGrad.apply(x.redistribute(x.device_mesh, [
            Replicate() if isinstance(p, Partial) else p
            for p in x.placements]))
    return x


class _ReplicatedGrad(torch.autograd.Function):
    """Identity whose backward reduces a partial DTensor gradient to a
    replicated one: the masked lookup's redistribution takes its gradient
    back only from a replicated one."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial, Replicate

        if is_distributed(g) and any(isinstance(p, Partial)
                                  for p in g.placements):
            g = g.redistribute(g.device_mesh, [
                Replicate() if isinstance(p, Partial) else p
                for p in g.placements])
        return g
