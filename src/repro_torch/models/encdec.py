"""Whisper-style encoder-decoder (whisper-medium), serving path.

PyTorch twin of the serving half of the JAX package's
``repro.models.encdec.EncDecModel``. The conv/audio frontend is a stub, as
there: ``frames [B, enc_frames, D]`` are precomputed frame embeddings. The
encoder output, projected once per decoder layer into cross-attention
K/V (:meth:`EncDecModel.encode_anchor`), is the bulk payload: it is
computed once, stays on the device as ``cross_kv``, and every decode step
reads it in place. Decoder self-attention uses the paged pool of the
decoder-only models.

Every prefill attention goes through ``ops.flash_attention``: the
decoder's causal self-attention through ``attention.prefill_attention``,
the encoder's self-attention and the cross-attention through
``attention.noncausal_attention`` (the JAX package uses
``dense_attention`` / ``blockwise_attention``; the zero keys its blockwise
branch adds are added there too). A decode step attends to its pages
through ``ops.paged_attention`` and to ``cross_kv`` with
``dense_attention``, as the JAX package does. Positions are sinusoidal,
added to the embeddings; a decode step computes only the rows at
``seq_lens`` (``layers.sinusoidal_rows``), where the JAX package builds a
table of ``2 ** 20`` rows every step. Parameters are the JAX package's
nested dict, layers stacked on a leading axis; layers run in a Python
loop. Serving computes in float32.

Training (:meth:`EncDecModel.forward`, :meth:`EncDecModel.loss_fn`) is
the reference's: every parameter cast to bfloat16, the encoder
(:meth:`EncDecModel.encode_train`) and the teacher-forced decoder
(:meth:`EncDecModel.decode_stack`) attending through
``attention.dense_or_blockwise`` (dense up to 1024 queries and keys,
blockwise above: at whisper's 1500 frames the encoder and the
cross-attention take the blockwise branch and attend to its zero keys,
F5), each layer rematerialised by ``remat``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.common.sharding import constrain, use_mesh
from repro_torch.common.types import ModelConfig
from repro_torch.kernels.ops import IMPLS
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    ParamSpec,
    abstract_params,
    argmax_last,
    count_template_params,
    embed_lookup,
    init_params,
    masked_nll,
    mlp_apply,
    mlp_template,
    param_axes,
    remat_call,
    rms_norm,
    sinusoidal_positions,
    sinusoidal_rows,
    split_heads,
    tree_map,
    unstack,
)
from repro_torch.models.transformer import stack_template


def _layer(stacked, i: int):
    """Layer ``i``'s parameters: views into the stacked tensors."""
    return tree_map(lambda a: a[i], stacked)


class EncDecModel:
    def __init__(self, cfg: ModelConfig, page_size: int = 64,
                 attn_impl: str = "auto"):
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: EncDecModel serves the encdec "
                             f"family, not {cfg.family!r}")
        if attn_impl not in IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r} (expected "
                             f"one of {IMPLS})")
        self.cfg = cfg
        self.page_size = page_size
        #: ``ops`` impl of the attention kernels: 'auto' runs the CUDA
        #: kernels on CUDA tensors, 'ref' the plain versions anywhere
        self.attn_impl = attn_impl

    # -- params -----------------------------------------------------------
    def _attn_tmpl(self) -> Dict:
        c = self.cfg
        return {
            "wq": ParamSpec((c.d_model, c.q_dim), ("fsdp", "tensor")),
            "wo": ParamSpec((c.q_dim, c.d_model), ("tensor", "fsdp")),
            "wk": ParamSpec((c.d_model, c.kv_dim), ("fsdp", "tensor")),
            "wv": ParamSpec((c.d_model, c.kv_dim), ("fsdp", "tensor")),
        }

    def enc_layer_template(self) -> Dict:
        c = self.cfg
        return {
            "ln1": ParamSpec((c.d_model,), (None,), init="zeros"),
            "attn": self._attn_tmpl(),
            "ln2": ParamSpec((c.d_model,), (None,), init="zeros"),
            "mlp": mlp_template(c.d_model, c.d_ff, "gelu"),
        }

    def dec_layer_template(self) -> Dict:
        c = self.cfg
        return {
            "ln1": ParamSpec((c.d_model,), (None,), init="zeros"),
            "self_attn": self._attn_tmpl(),
            "ln_x": ParamSpec((c.d_model,), (None,), init="zeros"),
            "cross_attn": self._attn_tmpl(),
            "ln2": ParamSpec((c.d_model,), (None,), init="zeros"),
            "mlp": mlp_template(c.d_model, c.d_ff, "gelu"),
        }

    def template(self) -> Dict:
        c = self.cfg
        return {
            "embed": ParamSpec((c.vocab_size, c.d_model), ("tensor", None),
                               fan_in_dims=(1,)),
            "enc_final_norm": ParamSpec((c.d_model,), (None,), init="zeros"),
            "dec_final_norm": ParamSpec((c.d_model,), (None,), init="zeros"),
            "enc_layers": stack_template(self.enc_layer_template(),
                                         c.enc_layers),
            "dec_layers": stack_template(self.dec_layer_template(),
                                         c.num_layers),
        }

    def init_params(self, seed: int, *, device="cuda"):
        """Random parameters from ``seed`` on ``device`` (a
        ``torch.Generator`` on that device draws them)."""
        device = torch.device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return init_params(gen, self.template(), device=device)

    def abstract_params(self, dtype=torch.float32):
        """Meta tensors of every parameter (the dry-run's; no memory)."""
        return abstract_params(self.template(), dtype)

    def param_axes(self):
        """Each parameter's logical sharding names."""
        return param_axes(self.template())

    def param_count(self) -> int:
        return count_template_params(self.template())

    # -- attention helper ---------------------------------------------------
    def _heads(self, x: torch.Tensor, w: torch.Tensor, heads: int):
        """``x @ w`` split into ``heads`` heads: [B, S, heads, hd]."""
        return split_heads(x @ w, heads, self.cfg.head_dim)

    def _qkv(self, p, hq: torch.Tensor, hkv: torch.Tensor,
             head_sharded: bool):
        """q, k, v ``[B, S, H, hd]`` of ``hq`` / ``hkv`` under the
        reference's constraint (heads over the model axis where they
        divide it, ``encdec.py:105-108``)."""
        c = self.cfg
        q = self._heads(hq, p["wq"], c.num_heads)
        k = self._heads(hkv, p["wk"], c.num_kv_heads)
        v = self._heads(hkv, p["wv"], c.num_kv_heads)
        if head_sharded:
            lg = ("batch", None, "act_heads", None)
            q, k, v = constrain(q, lg), constrain(k, lg), constrain(v, lg)
        return q, k, v

    def _mha(self, p, hq: torch.Tensor, hkv: torch.Tensor,
             head_sharded: bool = True) -> torch.Tensor:
        """Non-causal attention of ``hq [B, Sq, D]`` over ``hkv [B, Skv,
        D]`` with the projections ``p``, through
        ``attention.noncausal_attention`` (the encoder's self-attention;
        the decoder's causal use is training's)."""
        c = self.cfg
        out = attn.noncausal_attention(*self._qkv(p, hq, hkv, head_sharded),
                                       impl=self.attn_impl)
        return out.reshape(*hq.shape[:2], c.q_dim) @ p["wo"]

    def _mlp_residual(self, lp, x: torch.Tensor) -> torch.Tensor:
        h2 = rms_norm(x, lp["ln2"], self.cfg.norm_eps)
        out = mlp_apply(lp["mlp"], h2, "gelu")
        # the row-parallel product's partial sum reduced before the
        # residual (see _train_mha)
        return x + constrain(out, ("batch",) + (None,) * (out.dim() - 2)
                             + ("embed",))

    def _train_mha(self, p, hq: torch.Tensor, hkv: torch.Tensor,
                   pos_q: torch.Tensor, pos_kv: torch.Tensor,
                   causal: bool, head_sharded: bool = True) -> torch.Tensor:
        """Training's attention of ``hq [B, Sq, D]`` over ``hkv [B, Skv,
        D]``: the reference's ``_mha``, dense or blockwise by
        ``max(Sq, Skv)``."""
        c = self.cfg
        out = attn.dense_or_blockwise(
            *self._qkv(p, hq, hkv, head_sharded), pos_q, pos_kv,
            causal=causal)
        # reduce the tensor-parallel partial sum here (see TransformerLM's
        # _mixer_residual)
        return constrain(out.reshape(*hq.shape[:2], c.q_dim) @ p["wo"],
                         ("batch", None, "embed"))

    # -- training -------------------------------------------------------------
    def encode_train(self, params, frames: torch.Tensor, *,
                     remat: str = "full", head_sharded: bool = True
                     ) -> torch.Tensor:
        """The encoder in its training form (the reference's ``encode``):
        ``frames [B, F, D]`` in the parameters' dtype -> ``[B, F, D]``,
        each layer under ``remat``."""
        c = self.cfg
        b, f, _ = frames.shape
        pe = sinusoidal_positions(f, c.d_model, frames.device)
        x = constrain(frames + pe[None].to(frames.dtype),
                      ("batch", None, "embed"))
        pos = torch.arange(f, device=x.device).expand(b, f)
        for lp in unstack(params["enc_layers"]):
            def layer(xx, lp=lp):
                h = rms_norm(xx, lp["ln1"], c.norm_eps)
                xx = xx + self._train_mha(lp["attn"], h, h, pos, pos, False,
                                          head_sharded)
                return self._mlp_residual(lp, xx)
            x = remat_call(layer, x, remat)
        return rms_norm(x, params["enc_final_norm"], c.norm_eps)

    def decode_stack(self, params, tokens: torch.Tensor,
                     enc_out: torch.Tensor, *, remat: str = "full",
                     head_sharded: bool = True) -> torch.Tensor:
        """The teacher-forced decoder over ``tokens [B, S]`` and the
        encoder output: causal self-attention, cross-attention over every
        frame, the GELU MLP, each layer under ``remat``; then the final
        norm."""
        c = self.cfg
        b, s = tokens.shape
        f = enc_out.shape[1]
        pe = sinusoidal_positions(s, c.d_model, tokens.device)
        x = embed_lookup(params["embed"], tokens) \
            + pe[None].to(params["embed"].dtype)
        x = constrain(x, ("batch", None, "embed"))
        pos = torch.arange(s, device=x.device).expand(b, s)
        pos_f = torch.arange(f, device=x.device).expand(b, f)
        for lp in unstack(params["dec_layers"]):
            def layer(xx, lp=lp):
                h = rms_norm(xx, lp["ln1"], c.norm_eps)
                xx = xx + self._train_mha(lp["self_attn"], h, h, pos, pos,
                                          True, head_sharded)
                hx = rms_norm(xx, lp["ln_x"], c.norm_eps)
                xx = xx + self._train_mha(lp["cross_attn"], hx, enc_out, pos,
                                          pos_f, False, head_sharded)
                return self._mlp_residual(lp, xx)
            x = remat_call(layer, x, remat)
        return rms_norm(x, params["dec_final_norm"], c.norm_eps)

    def forward(self, params, tokens: torch.Tensor, frames: torch.Tensor, *,
                compute_dtype=torch.bfloat16, remat: str = "full",
                tp_size: int = 1):
        """Training forward: ``(decoder hidden [B, S, D], aux)``, ``aux`` a
        float32 zero. Every parameter and the frames are cast to
        ``compute_dtype`` first. Attention is head-sharded where the heads
        divide ``tp_size``."""
        hs = self.cfg.num_heads % max(tp_size, 1) == 0
        p = tree_map(lambda a: a.to(compute_dtype), params)
        enc_out = self.encode_train(p, frames.to(compute_dtype), remat=remat,
                                    head_sharded=hs)
        x = self.decode_stack(p, tokens, enc_out, remat=remat,
                              head_sharded=hs)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def loss_fn(self, params, batch: Dict[str, torch.Tensor], *,
                remat: str = "full", tp_size: int = 1):
        """The masked next-token NLL of ``batch`` (tokens, labels; -1 =
        masked; frames [B, F, D]), with no z-loss, as the reference's. The
        head is the tied embedding, a bfloat16 product widened to
        float32."""
        hidden, _ = self.forward(params, batch["tokens"], batch["frames"],
                                 remat=remat, tp_size=tp_size)
        logits = self.logits(params, hidden,
                             compute_dtype=torch.bfloat16).float()
        loss, _lse, _mask, ntok = masked_nll(logits, batch["labels"])
        return loss, {"loss": loss, "ntok": ntok}

    # -- encode ---------------------------------------------------------------
    @torch.no_grad()
    def encode(self, params, frames: torch.Tensor,
               head_sharded: bool = True) -> torch.Tensor:
        """frames [B, F, D] (precomputed frontend embeddings) -> encoder
        output [B, F, D]: sinusoidal positions added, ``enc_layers``
        pre-norm blocks of non-causal self-attention and a GELU MLP, then
        the final norm."""
        c = self.cfg
        f = frames.shape[1]
        x = frames + sinusoidal_positions(f, c.d_model,
                                          frames.device)[None].to(frames.dtype)
        x = constrain(x, ("batch", None, "embed"))
        for li in range(c.enc_layers):
            lp = _layer(params["enc_layers"], li)
            h = rms_norm(x, lp["ln1"], c.norm_eps)
            x = constrain(x + self._mha(lp["attn"], h, h, head_sharded),
                          ("batch", None, "embed"))
            x = self._mlp_residual(lp, x)
        return rms_norm(x, params["enc_final_norm"], c.norm_eps)

    # -- serving --------------------------------------------------------------
    def kv_pool_shape(self, total_pages: int) -> Tuple[int, ...]:
        c = self.cfg
        return (c.num_layers, total_pages, self.page_size, 2, c.num_kv_heads,
                c.head_dim)

    def cross_kv_shape(self, batch: int) -> Tuple[int, ...]:
        c = self.cfg
        return (c.num_layers, batch, c.enc_frames, 2, c.num_kv_heads,
                c.head_dim)

    def logits(self, params, hidden: torch.Tensor, weight_dtype=None,
               compute_dtype=None) -> torch.Tensor:
        """Logits of ``hidden`` through the tied embedding. With
        ``compute_dtype`` (training's bfloat16) the weights are cast to it
        and the product runs in it. With ``weight_dtype`` its weights are
        only rounded to that dtype (and computed with in ``hidden``'s).
        :meth:`decode_step` passes bfloat16: the JAX package's calls
        ``logits`` without ``compute_dtype``, whose default is bfloat16 (a
        fault of the reference, carried so that tokens agree)."""
        w = params["embed"]
        if compute_dtype is not None:
            w = w.to(compute_dtype)
        elif weight_dtype is not None:
            w = w.to(weight_dtype).to(hidden.dtype)
        out = hidden @ w.T
        if out.dim() == 3:
            out = constrain(out, ("batch", None, "vocab"))
        return out

    @torch.no_grad()
    def encode_anchor(self, params, frames: torch.Tensor,
                      head_sharded: bool = True) -> torch.Tensor:
        """Ingress for the audio payload: encode once and project the
        cross-attention K/V of every decoder layer, ``cross_kv [L, B, F,
        2, Hkv, hd]`` (:meth:`cross_kv_shape`), kept on the device."""
        c = self.cfg
        enc = self.encode(params, frames, head_sharded)
        b, f, _ = enc.shape
        cross_kv = enc.new_empty((c.num_layers, b, f, 2, c.num_kv_heads,
                                  c.head_dim))
        for li in range(c.num_layers):
            p = _layer(params["dec_layers"], li)["cross_attn"]
            cross_kv[li, :, :, 0] = self._heads(enc, p["wk"], c.num_kv_heads)
            cross_kv[li, :, :, 1] = self._heads(enc, p["wv"], c.num_kv_heads)
        return cross_kv

    @torch.no_grad()
    def prefill(
        self,
        params,
        tokens: torch.Tensor,       # [B, S] decoder prompt
        seq_lens: torch.Tensor,     # [B]
        pool: torch.Tensor,         # [L, P, page, 2, Hkv, hd], updated in place
        tables: torch.Tensor,       # [B, n_shards, pps]
        token_shard: torch.Tensor,  # [B, S]
        token_slot: torch.Tensor,
        token_off: torch.Tensor,
        token_valid: torch.Tensor,
        frames: torch.Tensor,       # [B, enc_frames, D]
        *,
        mesh=None,
        batch_axis=None,
        combine_axes=(),
        tp_size: int = 1,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ingress: anchor the audio payload (:meth:`encode_anchor`) and
        the decoder prompt's self-attention K/V pages (in place), and
        return ``(first_tokens [B] int32, cross_kv)``; the JAX package
        returns the new pool as well. The first token is sampled at
        ``seq_lens - 1``. The mesh keywords are ``TransformerLM.prefill``'s."""
        with use_mesh(mesh):
            return self._prefill(params, tokens, seq_lens, pool, tables,
                                 token_shard, token_slot, token_off,
                                 token_valid, frames, mesh, batch_axis,
                                 combine_axes, tp_size)

    def _prefill(self, params, tokens, seq_lens, pool, tables, token_shard,
                 token_slot, token_off, token_valid, frames, mesh, batch_axis,
                 combine_axes, tp_size: int):
        c = self.cfg
        head_sharded = c.num_heads % max(tp_size, 1) == 0
        cross_kv = self.encode_anchor(params, frames, head_sharded)
        x = embed_lookup(params["embed"], tokens)         # [B, S, D]
        b, s, _ = x.shape
        x = x + sinusoidal_positions(s, c.d_model, x.device)[None]
        x = constrain(x, ("batch", None, "embed"))
        write_kw = dict(mesh=mesh, batch_axis=batch_axis,
                        combine_axes=combine_axes)
        write_kw["write_index"] = attn.prefill_write_index(
            tables, token_shard, token_slot, token_off, token_valid,
            **write_kw)
        for li in range(c.num_layers):
            lp = _layer(params["dec_layers"], li)
            sp, xp = lp["self_attn"], lp["cross_attn"]
            h = rms_norm(x, lp["ln1"], c.norm_eps)
            q, k, v = self._qkv(sp, h, h, head_sharded)
            attn.prefill_write_pages(k, v, pool[li], tables, token_shard,
                                     token_slot, token_off, token_valid,
                                     **write_kw)
            out = attn.prefill_attention(q, k, v, impl=self.attn_impl)
            x = constrain(x + out.reshape(b, s, c.q_dim) @ sp["wo"],
                          ("batch", None, "embed"))
            hx = rms_norm(x, lp["ln_x"], c.norm_eps)
            qx = self._heads(hx, xp["wq"], c.num_heads)
            kx, vx = cross_kv[li, :, :, 0], cross_kv[li, :, :, 1]
            if head_sharded:
                lg = ("batch", None, "act_heads", None)
                qx, kx, vx = constrain(qx, lg), constrain(kx, lg), \
                    constrain(vx, lg)
            ox = attn.noncausal_attention(qx, kx, vx, impl=self.attn_impl)
            x = constrain(x + ox.reshape(b, s, c.q_dim) @ xp["wo"],
                          ("batch", None, "embed"))
            x = self._mlp_residual(lp, x)
        idx = (seq_lens.long() - 1).clamp(min=0)
        last = x[torch.arange(b, device=x.device), idx]         # [B, D]
        last = rms_norm(last, params["dec_final_norm"], c.norm_eps)
        first = argmax_last(self.logits(params, last)).to(torch.int32)
        return first, cross_kv

    @torch.no_grad()
    def decode_step(
        self,
        params,
        tokens: torch.Tensor,       # [B] current token ids
        seq_lens: torch.Tensor,     # [B] position of the incoming token
        pool: torch.Tensor,         # [L, P, page, 2, Hkv, hd], updated in place
        tables: torch.Tensor,       # [B, n_shards, pps]
        page_pos: torch.Tensor,     # [B, n_shards, pps]
        write_shard: torch.Tensor,  # [B]
        write_slot: torch.Tensor,   # [B]
        cross_kv: torch.Tensor,     # [L, B, F, 2, Hkv, hd]
        *,
        mesh=None,
        batch_axis=None,
        combine_axes=(),
    ) -> torch.Tensor:
        """One decoder token: paged self-attention (the token's K/V
        written into its page in place) and cross-attention over the
        anchored ``cross_kv``, read in place. Returns next_tokens [B]
        int32; the JAX package returns the new pool as well. The mesh
        keywords are ``TransformerLM.decode_step``'s."""
        with use_mesh(mesh):
            return self._decode_step(params, tokens, seq_lens, pool, tables,
                                     page_pos, write_shard, write_slot,
                                     cross_kv, mesh, batch_axis, combine_axes)

    def _decode_step(self, params, tokens, seq_lens, pool, tables, page_pos,
                     write_shard, write_slot, cross_kv, mesh, batch_axis,
                     combine_axes) -> torch.Tensor:
        c = self.cfg
        x = embed_lookup(params["embed"], tokens)         # [B, D]
        x = x + sinusoidal_rows(seq_lens, c.d_model).to(x.dtype)
        b = x.shape[0]
        f = cross_kv.shape[2]
        pos_f = torch.arange(f, device=x.device).expand(b, f)
        mesh_kw = dict(mesh=mesh, batch_axis=batch_axis,
                       combine_axes=combine_axes)
        mesh_kw["write_index"] = attn.decode_write_index(
            tables, page_pos, seq_lens, write_shard, write_slot,
            pool.shape[2], **mesh_kw)
        for li in range(c.num_layers):
            lp = _layer(params["dec_layers"], li)
            sp, xp = lp["self_attn"], lp["cross_attn"]
            h = rms_norm(x, lp["ln1"], c.norm_eps)[:, None]     # [B, 1, D]
            out = attn.paged_decode_attention(
                self._heads(h, sp["wq"], c.num_heads)[:, 0],
                self._heads(h, sp["wk"], c.num_kv_heads)[:, 0],
                self._heads(h, sp["wv"], c.num_kv_heads)[:, 0], pool[li],
                tables, page_pos, seq_lens, write_shard, write_slot,
                impl=self.attn_impl, **mesh_kw)
            x = x + out.reshape(b, c.q_dim) @ sp["wo"]
            hx = rms_norm(x, lp["ln_x"], c.norm_eps)[:, None]
            ox = attn.dense_attention(
                self._heads(hx, xp["wq"], c.num_heads), cross_kv[li, :, :, 0],
                cross_kv[li, :, :, 1], seq_lens[:, None], pos_f,
                causal=False)[:, 0]
            x = x + ox.reshape(b, c.q_dim) @ xp["wo"]
            x = self._mlp_residual(lp, x)
        x = rms_norm(x, params["dec_final_norm"], c.norm_eps)
        return argmax_last(self.logits(
            params, x, weight_dtype=torch.bfloat16)).to(torch.int32)
