"""The plain decoder that both families' references share.

Plain PyTorch in float32, TF32 off unless a control asks for it, with no
kernel, cache, page or batching of the program. It imports nothing of
``repro_torch`` and takes nothing the program made: the weights are the
benchmark's, the prompts and served tokens are read only to be judged,
and whatever the program derived from them (padding, pages, positions) is
worked out here again from the configuration's file.

:func:`served_logits` gives, for one served request, the logits that
predict each of its served tokens: the first from the prompt's last
position (the program's prefill, float32 head), the others from the
positions of the served tokens before them (the program's decode steps,
whose head reads its weights rounded to ``decode_head_weight_dtype``).
The prompt runs as the rows of its admission group, padded as the
program pads it, where the family's FFN couples the rows of a call
(``group_rows``); alone otherwise.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Products in float32 (``tf32=False``) or TF32 (the control's)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm scaled by ``1 + w``, the configuration's convention."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x [B, S, H, hd]`` at positions ``pos [S]``:
    the two halves of each head rotated together, float32 angles."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(0, 2 * half, 2, dtype=torch.float32,
                                       device=x.device) / (2 * half))
    ang = pos.to(torch.float32)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """Causal softmax attention, ``q [B, S, Hq, hd]`` over ``k, v [B, T,
    Hkv, hd]``; query head ``h`` reads key head ``h // (Hq / Hkv)``."""
    group = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(k_pos[None, :] > q_pos[:, None], -math.inf)
    return torch.einsum("bhst,bthd->bshd", scores.softmax(-1), v)


def block(lp: Dict, x: torch.Tensor, pos: torch.Tensor, past, model: Dict,
          ffn: Callable, call_rows: int):
    """One decoder layer over ``x [B, S, D]`` at positions ``pos``, after
    ``past = (k, v)`` of earlier positions (or ``None``): ``(x, k, v)``."""
    b, s, d = x.shape
    hq, hkv, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    h = rms_norm(x, lp["ln1"], model["norm_eps"])
    q = rope((h @ lp["wq"]).view(b, s, hq, hd), pos, model["rope_theta"])
    k = rope((h @ lp["wk"]).view(b, s, hkv, hd), pos, model["rope_theta"])
    v = (h @ lp["wv"]).view(b, s, hkv, hd)
    k_all, v_all, k_pos = k, v, pos
    if past is not None:
        k_all = torch.cat([past[0], k], dim=1)
        v_all = torch.cat([past[1], v], dim=1)
        k_pos = torch.arange(k_all.shape[1], device=x.device)
    out = attention(q, k_all, v_all, pos, k_pos).reshape(b, s, hq * hd)
    x = x + out @ lp["wo"]
    h2 = rms_norm(x, lp["ln2"], model["norm_eps"])
    x = x + ffn(lp, h2.reshape(b * s, d), call_rows).view(b, s, d)
    return x, k, v


def head(params: Dict, model: Dict, h: torch.Tensor, dtype=None) -> torch.Tensor:
    w = params["embed"].T if model["tie_embeddings"] else params["lm_head"]
    if dtype is not None:
        w = w.to(dtype).to(torch.float32)
    return h @ w


def layer(params: Dict, i: int) -> Dict:
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) else t[i]
    return pick(params["layers"])


@torch.no_grad()
def served_logits(params: Dict, model: Dict, serving: Dict, case: Dict,
                  ffn: Callable, group_rows: bool) -> torch.Tensor:
    """``[n, V]`` float32: row ``i`` the logits that predict served token
    ``i`` of ``case`` (``group``: the prompts of its admission group in
    row order, ``row``: its row, ``served``: its tokens, ``decode_rows``:
    the rows of a decode call)."""
    dev = params["embed"].device
    prompts = case["group"] if group_rows else [case["group"][case["row"]]]
    row = case["row"] if group_rows else 0
    n_prompt = len(prompts[row])
    page = serving["page_size"]
    width = max(len(p) for p in prompts)
    if group_rows:      # the program pads a group to whole pages
        width = max(page, -(-width // page) * page)
    tokens = np.zeros((len(prompts), width), np.int64)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    x = params["embed"][torch.from_numpy(tokens).to(dev)]
    pos = torch.arange(width, device=dev)
    kept = []
    for i in range(model["num_layers"]):
        x, k, v = block(layer(params, i), x, pos, None, model, ffn,
                        x.shape[0] * x.shape[1])
        kept.append((k[row:row + 1, :n_prompt], v[row:row + 1, :n_prompt]))
    final = params["final_norm"]
    eps = model["norm_eps"]
    logits = [head(params, model, rms_norm(x[row, n_prompt - 1], final, eps))[None]]
    served = case["served"]
    if len(served) > 1:
        x = params["embed"][torch.tensor(served[:-1], device=dev)][None]
        pos = torch.arange(n_prompt, n_prompt + len(served) - 1, device=dev)
        for i in range(model["num_layers"]):
            x, _k, _v = block(layer(params, i), x, pos, kept[i], model, ffn,
                              case["decode_rows"])
        dtype = DTYPES[serving.get("decode_head_weight_dtype", "float32")]
        logits.append(head(params, model, rms_norm(x[0], final, eps), dtype))
    return torch.cat(logits)
