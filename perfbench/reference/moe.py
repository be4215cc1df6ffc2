"""Plain reference of the ``moe`` family: a decoder with the q, k and v
biases where the configuration has ``qkv_bias``, whose FFN is a sparse-expert
block. A softmax router over the experts sends each row to its ``top_k``
experts, nothing dropped; the gates are the top-k probabilities as they are,
renormalised only where ``norm_topk`` is true. A shared SwiGLU expert that
every row visits is scaled by ``sigmoid(x w_gate)``. Rows do not meet, so
each request runs alone: its prompt, then its served tokens after the
prompt's K/V.

**Precision.** The reference computes in float64 from the float32
weights (the decode head's rounded to bfloat16 first, as the port's are)
and returns float32 logits: the exact answer to the float32 program's
scale. A float32 reference errs by as much as the program does: a
routing near-tie at a prompt position, ordered one way by one float32
sum and the other way by another, moves the logits of the positions
that attend to it by some 1e-5, as far as the configuration's limit, so
where two tokens of the vocabulary lie that close, a float32 reference
can put first the token the exact answer puts second. The control (TF32
products, :func:`common.matmul_precision`) computes in float32, in a
program's place.

**Routing near-ties.** Where a row's ``top_k``-th and next router logits
lie within float32 rounding of each other, a float32 program may order the
two either way, and the row's output then differs by a whole expert's
term. Each logit is a ``d_model``-term sum; its rounding error's root mean
square, for independent rounding errors, is at most ``sqrt(n) u sum_i
|h_i w_i|`` (``u = 2**-24``; the probabilistic bound of Higham and Mary,
SIAM J. Sci. Comput. 41(5), 2019, with lambda = 1), which lies some tens of
times above a float32 product's actual error, since the partial sums are
far below ``sum_i |h_i w_i|``. A pair is near where the two logits lie
within :data:`SCALE` times the sum of their two bounds. At a position
whose logits are judged (the prompt's last, and every served token's that
predicts the next), each layer where the row is near is run again from
that layer with the two experts swapped, one layer at a time, and every
token of the vocabulary takes its least gap below the best over those
routings: the row's logits become, token by token, the highest of each
routing's logits less that routing's best, plus the first routing's best.
The rule favours no token, so the program's tokens and the control's (the
TF32 reference's first choice, ``judge.gaps(..., tf32=True)``) pass
through the same comparison. The TF32 pass itself stands in for a program
and routes each row by its own logits. :data:`TIES` counts the near
positions. A near-tie at another prompt position reaches a judged logit
only through attention, and the configuration's limit takes it.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from perfbench.reference import common

U = 2.0 ** -24                     # float32's unit roundoff: the program's
#: the near-tie rule's width in bounds (0 leaves only exact ties)
SCALE = 1.0
#: judged positions with a routing near-tie in some layer, since the last
#: :func:`reset_ties`
TIES = {"positions": 0, "layers": 0}


def reset_ties() -> None:
    TIES["positions"] = TIES["layers"] = 0


def rms_bound(n: int) -> float:
    """The bound's factor on ``sum_i |h_i w_i|`` for an ``n``-term sum."""
    return SCALE * math.sqrt(n) * U


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in ``x``'s precision (float64, or float32 in the
    control), the float32 weights converted as they are read."""
    return x @ w.to(x.dtype)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    return mm(F.silu(mm(x, wg)) * mm(x, wu), wd)


def attend(lp: Dict, x: torch.Tensor, pos: torch.Tensor, past, model: Dict):
    """x [1, S, D] at positions ``pos`` after ``past = (k, v)`` of the
    positions before them: ``(x plus the attention's output, k, v)``."""
    b, s, _d = x.shape
    hq, hkv, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    h = common.rms_norm(x, lp["ln1"], model["norm_eps"])
    q, k, v = mm(h, lp["wq"]), mm(h, lp["wk"]), mm(h, lp["wv"])
    if model.get("qkv_bias"):
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = common.rope(q.view(b, s, hq, hd), pos, model["rope_theta"])
    k = common.rope(k.view(b, s, hkv, hd), pos, model["rope_theta"])
    v = v.view(b, s, hkv, hd)
    k_all, v_all, k_pos = k, v, pos
    if past is not None:
        k_all = torch.cat([past[0], k], dim=1)
        v_all = torch.cat([past[1], v], dim=1)
        k_pos = torch.arange(k_all.shape[1], device=x.device)
    out = common.attention(q, k_all, v_all, pos, k_pos).reshape(b, s, hq * hd)
    return x + mm(out, lp["wo"]), k, v


def experts(lp: Dict, h: torch.Tensor, model: Dict,
            swap: Optional[torch.Tensor] = None):
    """The sparse-expert block of ``h [T, D]``: ``(out [T, D], near [T])``,
    ``near`` where the row's ``top_k``-th and next logits lie within
    :func:`rms_bound` of each other. Rows of ``swap`` take the next expert
    in place of their ``top_k``-th."""
    m = lp["moe"]
    k, e = model["top_k"], model["num_experts"]
    logits = mm(h, m["router"])
    if logits.shape[-1] > e:                       # padded experts
        logits[:, e:] = -torch.inf
    probs = logits.softmax(-1)
    gates, ids = probs.topk(k + 1, dim=-1)
    bound = rms_bound(h.shape[-1]) * mm(h.abs(), m["router"].abs())
    a, b = ids[:, k - 1:k], ids[:, k:k + 1]
    near = ((logits.gather(1, a) - logits.gather(1, b))
            <= bound.gather(1, a) + bound.gather(1, b))[:, 0]
    if swap is not None:
        ids[swap, k - 1] = ids[swap, k]
        gates[swap, k - 1] = gates[swap, k]
    ids, gates = ids[:, :k], gates[:, :k]
    if model.get("norm_topk", True):
        gates = gates / gates.sum(-1, keepdim=True)
    terms = h.new_zeros((h.shape[0], k, h.shape[1]))
    for ex in ids.unique().tolist():
        rows, slot = (ids == ex).nonzero(as_tuple=True)
        terms[rows, slot] = gates[rows, slot, None] * swiglu(
            h[rows], m["w_gate"][ex], m["w_up"][ex], m["w_down"][ex])
    out = terms.sum(1)
    if model["num_shared_experts"]:
        out = out + torch.sigmoid(mm(h, m["shared_gate_proj"])) * swiglu(
            h, m["shared_gate"], m["shared_up"], m["shared_down"])
    return out, near


def layer(lp: Dict, x: torch.Tensor, pos: torch.Tensor, past, model: Dict,
          swap: Optional[torch.Tensor] = None):
    """One decoder layer over ``x [1, S, D]``: ``(x, k, v, mid, near)``,
    ``mid`` the residual stream between attention and the experts."""
    mid, k, v = attend(lp, x, pos, past, model)
    h2 = common.rms_norm(mid, lp["ln2"], model["norm_eps"])
    out, near = experts(lp, h2[0], model, swap)
    return mid + out[None], k, v, mid[0], near


@torch.no_grad()
def served_logits(params: Dict, model: Dict, serving: Dict,
                  case: Dict) -> torch.Tensor:
    """``[n, V]`` float32: row ``i`` the logits that predict served token
    ``i`` of ``case``, the request run alone (``common.served_logits``
    states the rest), computed in float64 (in float32 with TF32 products
    on, the control)."""
    dev = params["embed"].device
    control = torch.backends.cuda.matmul.allow_tf32     # in a program's place
    dt = torch.float32 if control else torch.float64
    prompt = torch.as_tensor(case["group"][case["row"]], device=dev).long()
    served = case["served"]
    n_prompt, n = len(prompt), len(served)
    eps, final = model["norm_eps"], params["final_norm"]
    dtype = common.DTYPES[serving.get("decode_head_weight_dtype", "float32")]
    layers = [common.layer(params, i) for i in range(model["num_layers"])]

    # the whole sequence's K/V, and at each judged row (the prompt's last
    # position, then each served token's but the last) the residual stream
    # before each layer's experts and whether its routing is near a tie
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    mids: List[torch.Tensor] = []
    nears: List[torch.Tensor] = []
    x = params["embed"][prompt][None].to(dt)
    pos = torch.arange(n_prompt, device=dev)
    for lp in layers:
        x, k, v, mid, near = layer(lp, x, pos, None, model)
        ks.append(k)
        vs.append(v)
        mids.append(mid[-1:])
        nears.append(near[-1:])
    last = [x[0, -1:]]
    if n > 1:
        x = params["embed"][torch.tensor(served[:-1], device=dev)][None].to(dt)
        pos = torch.arange(n_prompt, n_prompt + n - 1, device=dev)
        for i, lp in enumerate(layers):
            x, k, v, mid, near = layer(lp, x, pos, (ks[i], vs[i]), model)
            ks[i] = torch.cat([ks[i], k], dim=1)
            vs[i] = torch.cat([vs[i], v], dim=1)
            mids[i] = torch.cat([mids[i], mid])
            nears[i] = torch.cat([nears[i], near])
        last.append(x[0])
    hidden = torch.cat(last)                                   # [n, D]

    def head(h, row):
        w = params["embed"].T if model["tie_embeddings"] else params["lm_head"]
        if row:
            w = w.to(dtype)
        return mm(common.rms_norm(h, final, eps), w)

    logits = torch.cat([head(hidden[:1], 0)] +
                       ([head(hidden[1:], 1)] if n > 1 else []))
    if control:
        return logits
    near = torch.stack(nears)                                  # [L, n]
    rows = near.any(0).nonzero()[:, 0].tolist()
    TIES["positions"] += len(rows)
    for j in rows:
        p = n_prompt - 1 + j                                   # its position
        routings = [logits[j]]
        for li in near[:, j].nonzero()[:, 0].tolist():
            TIES["layers"] += 1
            lp = layers[li]
            h2 = common.rms_norm(mids[li][j], lp["ln2"], eps)
            out, _ = experts(lp, h2[None], model,
                             torch.ones(1, dtype=torch.bool, device=dev))
            x = (mids[li][j] + out[0])[None, None]
            at = torch.tensor([p], device=dev)
            for lj in range(li + 1, len(layers)):
                x, _k, _v, _m, _n = layer(layers[lj], x, at,
                                          (ks[lj][:, :p], vs[lj][:, :p]),
                                          model)
            routings.append(head(x[0, 0][None], j)[0])
        each = torch.stack(routings)
        below = each - each.max(-1, keepdim=True).values       # each <= 0
        logits[j] = below.max(0).values + logits[j].max()
    if rows:
        print(f"reference/moe: {len(rows)} of {n} judged positions near a "
              "routing tie", flush=True)
    return logits.float()
