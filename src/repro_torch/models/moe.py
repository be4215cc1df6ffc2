"""Mixture-of-Experts FFN with sort-based capacity dispatch.

PyTorch twin of the JAX package's ``repro.models.moe`` on one device:
tokens are sorted by expert id and gathered into a capacity-bounded
``[E, C, D]`` buffer, the per-expert FFN is one batched product a weight
(``torch.bmm``; plain XLA dots in the reference, no Pallas kernel), and
the combine sums each token's ``k`` expert outputs weighted by the router
gates. Tokens past an expert's capacity pass through the residual. Which
tokens are dropped follows the reference exactly: a stable sort,
``searchsorted`` from the left, the capacity counted over every row
passed in (padding included).

Dispatch and combine are gathers, and so are their backward passes: no
row is summed by atomic additions on a CUDA tensor, and two runs on the
same inputs give the same bits (training's exact resume needs that).
The reference scatter-adds (``.at[token_idx].add``) in expert order; the
combine here adds a token's ``k`` terms in choice order, so the two
differ by float rounding when ``k > 2``.

Under a mesh with a ``model`` axis of more than one rank that divides
``padded_experts`` (``common.sharding.use_mesh``), ``moe_ffn`` takes the
reference's expert-parallel path (its ``shard_map``, a ``local_map``
region here; ``repro/models/moe.py`` l.148-207): the FSDP shards of the
expert weights are all-gathered over ``data``, each ``model`` rank
dispatches the local tokens to its own ``padded_experts / model`` experts
(``e_first = model rank * e_local``; no token crosses devices), folds in
its slice of the shared expert, and one all-reduce over ``model`` in the
activations' dtype sums the partial outputs. The gradients follow
``shard_map``'s transpose: the all-reduce passes its gradient through
unchanged, the weight gather's backward is a reduce-scatter, and an
input replicated over an axis that computes differently on each rank
gets a partial gradient over it (``in_grad_placements``).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.sharding import (
    _current_mesh,
    all_gather,
    contiguous_grad,
    axis_index,
    is_distributed,
    mesh_axis_names,
    mesh_axis_sizes,
    placements_for,
    psum_identity_grad,
)
from repro_torch.common.types import ModelConfig
from repro_torch.models.layers import ParamSpec


def moe_template(cfg: ModelConfig) -> Dict:
    e = cfg.padded_experts
    t: Dict = {
        "router": ParamSpec((cfg.d_model, e), (None, None)),
        "w_gate": ParamSpec((e, cfg.d_model, cfg.expert_d_ff),
                            ("expert", "fsdp", "tensor")),
        "w_up": ParamSpec((e, cfg.d_model, cfg.expert_d_ff),
                          ("expert", "fsdp", "tensor")),
        "w_down": ParamSpec((e, cfg.expert_d_ff, cfg.d_model),
                            ("expert", "tensor", "fsdp")),
    }
    if cfg.num_shared_experts:
        sf = cfg.num_shared_experts * cfg.expert_d_ff
        t["shared_gate"] = ParamSpec((cfg.d_model, sf), ("fsdp", "tensor"))
        t["shared_up"] = ParamSpec((cfg.d_model, sf), ("fsdp", "tensor"))
        t["shared_down"] = ParamSpec((sf, cfg.d_model), ("tensor", "fsdp"))
        t["shared_gate_proj"] = ParamSpec((cfg.d_model, 1), ("fsdp", None))
    return t


def router_topk(logits: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[T, E_padded] -> (gates [T, k], expert_ids [T, k]). Padded experts
    are masked out before top-k so they can never be selected."""
    if cfg.padded_experts > cfg.num_experts:
        pad = torch.arange(cfg.padded_experts,
                           device=logits.device) >= cfg.num_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits.float(), dim=-1)
    gates, ids = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return gates, ids


def aux_load_balance_loss(logits: torch.Tensor, ids: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss."""
    e = cfg.num_experts
    probs = torch.softmax(logits.float(), dim=-1)[..., :e]
    me = probs.mean(dim=0)
    one_hot = F.one_hot(ids.long(), cfg.padded_experts).float()[..., :e]
    ce = one_hot.sum(dim=1).mean(dim=0) / cfg.top_k
    return e * (me * ce).sum()


def expert_capacity(t: int, cfg: ModelConfig, capacity_factor: float) -> int:
    """Slots an expert has for ``t`` rows: at least 8, at most ``t``."""
    cap = max(8, int(math.ceil(t * cfg.top_k / cfg.padded_experts
                               * capacity_factor)))
    return min(cap, t)


class DispatchPlan(NamedTuple):
    """Where each of the ``T*k`` (token, choice) entries goes, in expert
    order: ``order`` sorts the flat choices, ``token_idx`` is each sorted
    entry's token, ``kept`` whether it has a slot among this call's
    experts, ``dst`` its row of the ``[e_count * cap]`` buffer
    (``e_count * cap``, one past the end, where it has none)."""
    order: torch.Tensor
    token_idx: torch.Tensor
    kept: torch.Tensor
    dst: torch.Tensor


def dispatch_plan(ids: torch.Tensor, cfg: ModelConfig, cap: int,
                  e_first: int, e_count: int) -> DispatchPlan:
    k = cfg.top_k
    flat_e = ids.reshape(-1)                       # [T*k] global expert ids
    n = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    first = torch.searchsorted(
        se, torch.arange(cfg.padded_experts, device=se.device,
                         dtype=se.dtype), right=False)
    pos = torch.arange(n, device=se.device) - first[se]   # within its expert
    local_e = se - e_first
    kept = (local_e >= 0) & (local_e < e_count) & (pos < cap)
    dst = torch.where(kept, local_e * cap + pos,
                      torch.full_like(pos, e_count * cap))
    return DispatchPlan(order, order // k, kept, dst)


def dispatch(x: torch.Tensor, plan: DispatchPlan, cap: int,
             e_count: int) -> torch.Tensor:
    """The ``[e_count, cap, D]`` buffer of kept tokens, zero elsewhere
    (the reference's ``.at[dst].set(..., mode="drop")``). Each slot reads
    the entry it holds from x's rows repeated ``k`` times, an empty slot a
    zero row past them: the gather's backward adds at most one term into
    each entry, and a token's ``k`` entries are summed by the repeat's
    backward, in a fixed order."""
    t, d = x.shape
    n = plan.order.numel()                         # T*k entries
    k = n // max(t, 1)
    # the entry in each slot; dropped entries write the extra last slot
    src = torch.full((e_count * cap + 1,), n, dtype=plan.order.dtype,
                     device=x.device)
    src[plan.dst] = plan.order
    rows = torch.cat([x[:, None].expand(t, k, d).reshape(n, d),
                      x.new_zeros((1, d))])
    return rows[src[:-1]].view(e_count, cap, d)


def expert_ffn(buf: torch.Tensor, p_gate: torch.Tensor, p_up: torch.Tensor,
               p_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its slots: ``[E, C, D] -> [E, C, D]``."""
    h = F.silu(torch.bmm(buf, p_gate)) * torch.bmm(buf, p_up)
    return torch.bmm(h, p_down)


def combine(out_e: torch.Tensor, gates: torch.Tensor, plan: DispatchPlan,
            t: int) -> torch.Tensor:
    """Each token's kept entries' expert outputs, weighted by their gates
    and summed over its ``k`` choices: ``[T, D]``. A dropped entry reads a
    zero row past the buffer."""
    d = out_e.shape[-1]
    flat = torch.cat([out_e.reshape(-1, d), out_e.new_zeros((1, d))])
    dst = torch.empty_like(plan.dst)               # each entry's row,
    dst[plan.order] = plan.dst                     # in token order
    contrib = flat[dst] * gates.reshape(-1, 1).to(out_e.dtype)
    return contrib.view(t, dst.numel() // max(t, 1), d).sum(dim=1)


def _dispatch_compute_combine(x, p_gate, p_up, p_down, gates, ids, cfg,
                              capacity_factor: float, e_first: int,
                              e_count: int) -> torch.Tensor:
    """Sort-based dispatch for experts [e_first, e_first+e_count) over local
    tokens x [T, D]; returns the weighted combined output [T, D]."""
    t = x.shape[0]
    cap = expert_capacity(t, cfg, capacity_factor)
    plan = dispatch_plan(ids, cfg, cap, e_first, e_count)
    out_e = expert_ffn(dispatch(x, plan, cap, e_count), p_gate, p_up, p_down)
    return combine(out_e, gates, plan, t)


def _shared_expert(p, x: torch.Tensor) -> torch.Tensor:
    sh = F.silu(x @ p["shared_gate"]) * (x @ p["shared_up"])
    sg = torch.sigmoid(x @ p["shared_gate_proj"])
    return sg * (sh @ p["shared_down"])


def moe_ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
            capacity_factor: float = 1.25, return_aux: bool = False):
    """x [T, D] -> [T, D] (and the auxiliary loss with ``return_aux``).
    Without a mesh that shards the experts, the reference's one-device
    path, every expert local; with one, the expert-parallel path (the
    module's docstring). The serving paths pass ``capacity_factor=2.0``;
    1.25 is training's."""
    mesh = _current_mesh()
    e = cfg.padded_experts
    if mesh is not None:
        m_size = mesh_axis_sizes(mesh).get("model", 1)
        if m_size > 1 and e % m_size == 0:
            out, aux = _moe_ffn_ep(p, x, cfg, mesh, capacity_factor)
            return (out, aux) if return_aux else out
    logits = x @ p["router"]
    gates, ids = router_topk(logits, cfg)
    out = _dispatch_compute_combine(x, p["w_gate"], p["w_up"], p["w_down"],
                                    gates, ids, cfg, capacity_factor, 0,
                                    cfg.padded_experts)
    if cfg.num_shared_experts:
        out = out + _shared_expert(p, x)
    if return_aux:
        return out, aux_load_balance_loss(logits, ids, cfg)
    return out


def _moe_ffn_ep(p: Dict, x: torch.Tensor, cfg: ModelConfig, mesh,
                capacity_factor: float):
    """The expert-parallel ``moe_ffn`` over ``mesh``: ``(out, aux)``.
    DTensor inputs are placed as the reference's ``in_specs`` and unwrapped
    by ``local_map``; plain tensors are taken to be this rank's shards
    already."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    sizes = mesh_axis_sizes(mesh)
    names = mesh_axis_names(mesh)
    e_local = cfg.padded_experts // sizes["model"]
    data = "data" if "data" in sizes else None
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    shared = bool(cfg.num_shared_experts)

    def body(x, router, wg, wu, wd, *sh):
        x, router, wg, wu, wd = (contiguous_grad(t)
                                 for t in (x, router, wg, wu, wd))
        sh = tuple(contiguous_grad(t) for t in sh)
        if data:
            wg = all_gather(wg, 1, mesh, data)
            wu = all_gather(wu, 1, mesh, data)
            wd = all_gather(wd, 2, mesh, data)
        logits = x @ router
        gates, ids = router_topk(logits, cfg)
        e_first = axis_index(mesh, "model") * e_local
        partial = _dispatch_compute_combine(x, wg, wu, wd, gates, ids, cfg,
                                            capacity_factor, e_first, e_local)
        aux = aux_load_balance_loss(logits, ids, cfg)
        if sh:
            # the shared expert is TP-sharded over 'model' (its sf dim): its
            # contribution is partial over 'model' too, folded into one sum
            sg, su, sd, sgp = sh
            if data:
                sg = all_gather(sg, 0, mesh, data)
                su = all_gather(su, 0, mesh, data)
                sd = all_gather(sd, 1, mesh, data)
            hs = F.silu(x @ sg) * (x @ su)
            partial = partial + torch.sigmoid(x @ sgp) * (hs @ sd)
        # combine in the activations' dtype, as the reference does
        return psum_identity_grad(partial.to(x.dtype), mesh, ("model",)), aux

    args = [x, p["router"], p["w_gate"], p["w_up"], p["w_down"]]
    if shared:
        args += [p["shared_gate"], p["shared_up"], p["shared_down"],
                 p["shared_gate_proj"]]
    if not is_distributed(x):
        return body(*args)
    from torch.distributed.tensor.experimental import local_map

    t = x.shape[0]
    n_data = 1
    for a in data_axes:
        n_data *= sizes[a]
    dshard = (data_axes if len(data_axes) > 1 else data_axes[0]) \
        if data_axes and t % n_data == 0 else None
    x_pl = placements_for((dshard, None), mesh)
    w_pl = placements_for(("model", data, None), mesh)
    wd_pl = placements_for(("model", None, data), mesh)
    rep = placements_for((None, None), mesh)
    in_pl = [x_pl, rep, w_pl, w_pl, wd_pl]
    # the gradient of an input replicated over an axis whose ranks compute
    # differently (other experts over 'model', other tokens where x is
    # sharded) is partial over that axis
    def grad_pl(pl):
        return tuple(Partial() if isinstance(q, Replicate) and (
            a == "model" or isinstance(xq, Shard)) else q
            for a, q, xq in zip(names, pl, x_pl))
    if shared:
        sf_pl = placements_for((data, "model"), mesh)
        in_pl += [sf_pl, sf_pl, placements_for(("model", data), mesh), rep]
    out, aux = local_map(body, out_placements=(list(x_pl), list(rep)),
                         in_placements=tuple(in_pl),
                         in_grad_placements=tuple(grad_pl(q) for q in in_pl),
                         device_mesh=mesh, redistribute_inputs=True)(*args)
    return out, aux
