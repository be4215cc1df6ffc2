"""Decoder-only LM of the dense family, serving path.

PyTorch twin of the JAX package's ``repro.models.transformer.TransformerLM``
for ``family == "dense"`` (phi3, phi4, the libra-proxy model). Serving
follows the Libra datapath: ``prefill`` anchors KV into pool pages in place
(ingress) and attends through ``ops.flash_attention``; ``decode_step`` reads
the pages via block-table metadata through ``ops.paged_attention`` and
returns *only sampled token ids*. Parameters are the JAX package's nested
dict, layers stacked on a leading axis; the large products stay
``torch.matmul``, as they are plain XLA dots there. Layers run in a Python
loop (the JAX package scans them). Computation is float32.

The ``moe``, ``hybrid`` and ``vlm`` families, training and the contiguous
baseline (``prefill_dense`` / ``decode_step_dense``) are not ported yet
(``ROADMAP.md``, queue 1, items 6 to 8).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.common.types import ModelConfig
from repro_torch.kernels.ops import IMPLS
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    ParamSpec,
    apply_rope,
    count_template_params,
    init_params,
    mlp_apply,
    mlp_template,
    rms_norm,
    tree_map,
)

PORTED_FAMILIES = ("dense",)


def stack_template(tmpl: Dict, n: int) -> Dict:
    """Prepend a stacked 'layers' dim to every ParamSpec in a template."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init,
                            s.scale, tuple(d + 1 for d in s.fan_in_dims)),
        tmpl)


def layer_params(params, i: int):
    """Layer ``i``'s parameters: views into the stacked tensors."""
    return tree_map(lambda a: a[i], params["layers"])


class TransformerLM:
    def __init__(self, cfg: ModelConfig, page_size: int = 64,
                 attn_impl: str = "auto"):
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family!r} family is not ported yet "
                "(ROADMAP.md, queue 1, item 7)")
        if attn_impl not in IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r} (expected "
                             f"one of {IMPLS})")
        self.cfg = cfg
        self.page_size = page_size
        #: ``ops`` impl of the attention kernels: 'auto' runs the CUDA
        #: kernels on CUDA tensors, 'ref' the plain versions anywhere
        self.attn_impl = attn_impl

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def layer_template(self) -> Dict:
        c = self.cfg
        t: Dict[str, Any] = {
            "ln1": ParamSpec((c.d_model,), (None,), init="zeros"),
            "wq": ParamSpec((c.d_model, c.q_dim), ("fsdp", "tensor")),
            "wk": ParamSpec((c.d_model, c.kv_dim), ("fsdp", "tensor")),
            "wv": ParamSpec((c.d_model, c.kv_dim), ("fsdp", "tensor")),
            "wo": ParamSpec((c.q_dim, c.d_model), ("tensor", "fsdp")),
            "ln2": ParamSpec((c.d_model,), (None,), init="zeros"),
        }
        if c.qk_norm:
            t["q_norm"] = ParamSpec((c.head_dim,), (None,), init="zeros")
            t["k_norm"] = ParamSpec((c.head_dim,), (None,), init="zeros")
        t["mlp"] = mlp_template(c.d_model, c.d_ff, c.act)
        return t

    def template(self) -> Dict:
        c = self.cfg
        t: Dict[str, Any] = {
            "embed": ParamSpec((c.vocab_size, c.d_model), ("tensor", None),
                               scale=1.0, fan_in_dims=(1,)),
            "final_norm": ParamSpec((c.d_model,), (None,), init="zeros"),
            "layers": stack_template(self.layer_template(), c.num_layers),
        }
        if not c.tie_embeddings:
            t["lm_head"] = ParamSpec((c.d_model, c.vocab_size),
                                     ("fsdp", "tensor"))
        return t

    def init_params(self, seed: int, *, device="cuda"):
        """Random parameters from ``seed`` on ``device`` (a
        ``torch.Generator`` on that device draws them)."""
        device = torch.device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return init_params(gen, self.template(), device=device)

    def param_count(self) -> int:
        return count_template_params(self.template())

    # ------------------------------------------------------------------
    # shared pieces
    # ------------------------------------------------------------------
    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens.long()]

    def logits(self, params, hidden: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        w = params["embed"].T if c.tie_embeddings else params["lm_head"]
        out = hidden @ w
        if c.embed_scale != 1.0:
            out = out * c.embed_scale
        if c.logit_soft_cap > 0:
            out = torch.tanh(out / c.logit_soft_cap) * c.logit_soft_cap
        return out

    def _qkv(self, lp, h: torch.Tensor, positions: torch.Tensor):
        """Projections of the normed input h [..., D] into q [..., Hq, hd]
        and k, v [..., Hkv, hd], with qk-norm and RoPE at ``positions``
        (shaped like ``h`` without its last dim)."""
        c = self.cfg
        lead = h.shape[:-1]
        q = (h @ lp["wq"]).reshape(*lead, c.num_heads, c.head_dim)
        k = (h @ lp["wk"]).reshape(*lead, c.num_kv_heads, c.head_dim)
        v = (h @ lp["wv"]).reshape(*lead, c.num_kv_heads, c.head_dim)
        if c.qk_norm:
            q = rms_norm(q, lp["q_norm"], c.norm_eps)
            k = rms_norm(k, lp["k_norm"], c.norm_eps)
        return (apply_rope(q, positions, c.rope_theta),
                apply_rope(k, positions, c.rope_theta), v)

    def _mlp_residual(self, lp, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        h2 = rms_norm(x, lp["ln2"], c.norm_eps)
        return x + mlp_apply(lp["mlp"], h2, c.act) * c.residual_scale

    # ------------------------------------------------------------------
    # serving: Libra fast path (paged, anchored)
    # ------------------------------------------------------------------
    def kv_pool_shape(self, total_pages: int) -> Tuple[int, ...]:
        c = self.cfg
        return (c.num_layers, total_pages, self.page_size, 2, c.num_kv_heads,
                c.head_dim)

    @torch.no_grad()
    def decode_step(
        self,
        params,
        tokens: torch.Tensor,       # [B] current token ids
        seq_lens: torch.Tensor,     # [B] position of the incoming token
        pool: torch.Tensor,         # [L, P, page, 2, Hkv, hd], updated in place
        tables: torch.Tensor,       # [B, 1, pps]
        page_pos: torch.Tensor,     # [B, 1, pps]
        write_shard: torch.Tensor,  # [B]
        write_slot: torch.Tensor,   # [B]
    ) -> torch.Tensor:
        """One Libra decode step. Returns next_tokens [B] int32; the pool
        is updated in place.

        Host<->device traffic: token ids + O(pages) int32 metadata in;
        token ids out. The KV payload never leaves the pool."""
        c = self.cfg
        x = self.embed(params, tokens)                          # [B, D]
        b = x.shape[0]
        widx = attn.decode_write_index(tables, page_pos, seq_lens,
                                       write_shard, write_slot, pool.shape[2])
        for li in range(c.num_layers):
            lp = layer_params(params, li)
            h = rms_norm(x, lp["ln1"], c.norm_eps)
            q, k, v = self._qkv(lp, h[:, None], seq_lens[:, None])
            out = attn.paged_decode_attention(
                q[:, 0], k[:, 0], v[:, 0], pool[li], tables, page_pos,
                seq_lens, write_shard, write_slot, impl=self.attn_impl,
                write_index=widx)
            x = x + (out.reshape(b, c.q_dim) @ lp["wo"]) * c.residual_scale
            x = self._mlp_residual(lp, x)
        x = rms_norm(x, params["final_norm"], c.norm_eps)
        return self.logits(params, x).argmax(dim=-1).to(torch.int32)

    @torch.no_grad()
    def prefill(
        self,
        params,
        tokens: torch.Tensor,       # [B, S]
        seq_lens: torch.Tensor,     # [B]
        pool: torch.Tensor,         # [L, P, page, 2, Hkv, hd], updated in place
        tables: torch.Tensor,       # [B, 1, pps]
        token_shard: torch.Tensor,  # [B, S]
        token_slot: torch.Tensor,
        token_off: torch.Tensor,
        token_valid: torch.Tensor,
    ) -> torch.Tensor:
        """Ingress: run the prompt, anchor its KV into pool pages in place,
        return the first sampled tokens [B] int32. Only token ids ever
        surface to the host."""
        c = self.cfg
        x = self.embed(params, tokens)                          # [B, S, D]
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        widx = attn.prefill_write_index(tables, token_shard, token_slot,
                                        token_off, token_valid)
        for li in range(c.num_layers):
            lp = layer_params(params, li)
            h = rms_norm(x, lp["ln1"], c.norm_eps)
            q, k, v = self._qkv(lp, h, positions)
            attn.prefill_write_pages(k, v, pool[li], tables, token_shard,
                                     token_slot, token_off, token_valid,
                                     write_index=widx)
            out = attn.prefill_attention(q, k, v, impl=self.attn_impl)
            x = x + (out.reshape(b, s, c.q_dim) @ lp["wo"]) * c.residual_scale
            x = self._mlp_residual(lp, x)
        # sample the first output token from the last valid position
        idx = (seq_lens.long() - 1).clamp(min=0)
        last = x[torch.arange(b, device=x.device), idx]         # [B, D]
        last = rms_norm(last, params["final_norm"], c.norm_eps)
        return self.logits(params, last).argmax(dim=-1).to(torch.int32)
