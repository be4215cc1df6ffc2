"""Decoder-only LM of the dense, ``moe``, ``hybrid`` and ``vlm`` families,
serving path.

PyTorch twin of the JAX package's ``repro.models.transformer.TransformerLM``
for ``family == "dense"`` (phi3, phi4, minicpm, mistral-nemo, the
libra-proxy model), ``family == "moe"`` (qwen2-moe, qwen3-moe: the FFN
is ``models/moe.moe_ffn``, one call a layer over all ``B*S`` rows, padded
positions included, at ``SERVE_CAPACITY_FACTOR``) and
``family == "hybrid"`` (hymba: each layer runs a Mamba mixer,
``models/ssm``, beside its attention on the same normed input and adds
the mean of the two branches, each RMS-normed; attention is windowed on
every layer but the config's global ones, see :func:`layer_groups`)
and ``family == "vlm"`` (internvl2: :meth:`TransformerLM.embed` puts the
image's patch embeddings, projected by ``img_proj``, in front of the
text, and :meth:`TransformerLM.prefill` anchors both; see its docstring
for the positions ``seq_lens`` counts). Serving follows the Libra
datapath: ``prefill`` anchors KV into pool pages in place (ingress) and
attends through ``ops.flash_attention``;
``decode_step`` reads the pages via block-table metadata through
``ops.paged_attention`` and returns *only sampled token ids*. The
standard-stack baseline of the other engines is ``prefill_dense`` (the
prompt's KV as a contiguous cache, its attention through
``ops.flash_attention`` too) and ``decode_step_dense`` (the whole cache
rewritten every step unless donated, full logits out). Parameters are the
JAX package's nested dict, layers stacked on a leading axis. Layers run in
a Python loop (the JAX package scans them). Serving computes in float32.

The large products are plain XLA dots in the JAX package. Here the
prefill's per-layer projections (``wq``, ``wk``, ``wv``, ``wo`` and a dense
FFN's products, in ``prefill`` and ``prefill_dense``) go to
``ops.linear_f32``: on CUDA tensors a split-TF32 tensor-core kernel of
float32 accuracy, which the float32 configurations leave to the CUDA cores
otherwise; on the CPU ``torch.matmul``. The others stay ``torch.matmul``:
the decode steps' (host-bound, see PERF.md), the heads, training's
(bfloat16), the MoE experts', the Mamba mixer's, the image projection's,
and every product over a mesh (DTensors).

Training (:meth:`TransformerLM.forward`, :meth:`TransformerLM.loss_fn`)
follows the reference's training form: every parameter cast to
``compute_dtype`` (bfloat16) first, attention through
``attention.dense_or_blockwise`` (dense up to 1024 positions, the
blockwise custom backward above; never the forward-only kernels), MoE
layers at ``TRAIN_CAPACITY_FACTOR`` with their load-balancing loss, each
layer rematerialised by ``remat`` (``layers.remat_call``), the stacked
layer tensors unbound once a forward (``layers.unstack``).

Over a mesh (the reference's keywords: ``mesh=``, ``batch_axis=``,
``combine_axes=`` of the serving paths, ``tp_size=`` of training and
prefill, whose heads are sharded where they divide it: the reference's
``head_sharded``) the parameters and inputs are DTensors placed by
``common.sharding``'s rules, the paged attention is the flash-decode
region of ``models/attention``, a ``moe`` layer takes the expert-parallel
path of ``moe_ffn``, and the reference's ``constrain`` points redistribute
the activations. On plain tensors with no mesh every one of them is a
no-op.

The ``encdec`` family is ``models/encdec.EncDecModel``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.common.sharding import constrain, gather_fsdp, use_mesh
from repro_torch.common.tracing import span
from repro_torch.common.types import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    ParamSpec,
    abstract_params,
    argmax_last,
    apply_rope,
    count_template_params,
    embed_lookup,
    init_params,
    masked_nll,
    mlp_apply,
    mlp_template,
    param_axes,
    remat_call,
    rms_norm,
    split_heads,
    tree_map,
    unstack,
)

#: the families this model serves (``registry.build_model`` builds the
#: others' models)
FAMILIES = ("dense", "moe", "hybrid", "vlm")
#: an MoE layer's capacity factor on the serving paths and in training,
#: the reference's values
SERVE_CAPACITY_FACTOR = 2.0
TRAIN_CAPACITY_FACTOR = 1.25


def stack_template(tmpl: Dict, n: int) -> Dict:
    """Prepend a stacked 'layers' dim to every ParamSpec in a template."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init,
                            s.scale, tuple(d + 1 for d in s.fan_in_dims)),
        tmpl)


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    start: int
    end: int
    window: int  # 0 = global attention


def layer_groups(cfg: ModelConfig) -> List[LayerGroup]:
    """Runs of layers that share an attention window: under ``hybrid``,
    the windowed runs around each of ``global_attn_layers`` (window 0);
    one run of every layer otherwise."""
    if cfg.family != "hybrid" or not cfg.global_attn_layers:
        return [LayerGroup(0, cfg.num_layers,
                           cfg.window if cfg.family == "hybrid" else 0)]
    groups: List[LayerGroup] = []
    cur = 0
    for g in sorted(cfg.global_attn_layers):
        if g > cur:
            groups.append(LayerGroup(cur, g, cfg.window))
        groups.append(LayerGroup(g, g + 1, 0))
        cur = g + 1
    if cur < cfg.num_layers:
        groups.append(LayerGroup(cur, cfg.num_layers, cfg.window))
    return groups


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Each layer's attention window (0 = global), from
    :func:`layer_groups`."""
    return [grp.window for grp in layer_groups(cfg)
            for _ in range(grp.start, grp.end)]


def layer_params(params, i: int):
    """Layer ``i``'s parameters: views into the stacked tensors."""
    return tree_map(lambda a: a[i], params["layers"])


class TransformerLM:
    def __init__(self, cfg: ModelConfig, page_size: int = 64,
                 attn_impl: str = "auto"):
        if cfg.family not in FAMILIES:
            raise ValueError(f"{cfg.name}: TransformerLM serves the families "
                             f"{FAMILIES}, not {cfg.family!r}")
        if attn_impl not in ops.IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r} (expected "
                             f"one of {ops.IMPLS})")
        self.cfg = cfg
        self.page_size = page_size
        #: each layer's attention window (0 = global)
        self.windows = layer_windows(cfg)
        #: ``ops`` impl of the attention kernels and of the prefill's
        #: projections (``linear_f32``): 'auto' runs the CUDA kernels on
        #: CUDA tensors, 'ref' the plain versions anywhere
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
        if c.family == "moe":
            t["moe"] = moe_lib.moe_template(c)
        else:
            t["mlp"] = mlp_template(c.d_model, c.d_ff, c.act)
        if c.family == "hybrid":
            t["ssm"] = ssm_lib.mamba_template(c.d_model, c.ssm_state,
                                              c.ssm_conv, c.ssm_expand)
            t["attn_branch_norm"] = ParamSpec((c.d_model,), (None,),
                                              init="zeros")
            t["ssm_branch_norm"] = ParamSpec((c.d_model,), (None,),
                                             init="zeros")
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
        if c.family == "vlm":
            # projection stub applied to precomputed patch embeddings
            t["img_proj"] = ParamSpec((c.d_model, c.d_model),
                                      ("fsdp", "tensor"))
        return t

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

    # ------------------------------------------------------------------
    # shared pieces
    # ------------------------------------------------------------------
    def embed(self, params, tokens: torch.Tensor,
              img_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The prompt's embeddings ``[B, S, D]``. Under ``vlm`` the image
        comes first: ``img_embeds [B, img_tokens, D]`` (precomputed patch
        embeddings) times ``img_proj``, then the text's ``S_text`` tokens;
        it is required there (``ValueError`` without it, where the JAX
        package asserts) and refused elsewhere. The image product runs in
        the wider of the two dtypes, as JAX promotes."""
        x = embed_lookup(params["embed"], tokens)
        if self.cfg.family != "vlm":
            if img_embeds is not None:
                raise ValueError(f"{self.cfg.name}: img_embeds is for the "
                                 "vlm family")
            return x
        if img_embeds is None:
            raise ValueError(f"{self.cfg.name}: vlm needs patch embeddings")
        w = params["img_proj"]
        dt = torch.promote_types(img_embeds.dtype, w.dtype)
        img = img_embeds.to(dt) @ w.to(dt)
        return torch.cat([img.to(x.dtype), x], dim=1)

    def logits(self, params, hidden: torch.Tensor, weight_dtype=None,
               compute_dtype=None) -> torch.Tensor:
        """Logits of ``hidden``. With ``compute_dtype`` (training's
        bfloat16) the head's weights are cast to it and the product runs
        in it, as the reference's ``logits`` computes. With
        ``weight_dtype`` the weights are only rounded to that dtype and
        the product runs in ``hidden``'s: both decode steps pass bfloat16,
        since the JAX package's call their ``logits`` without
        ``compute_dtype``, whose default is bfloat16, on float32 hidden
        states (a fault of the reference, carried so that tokens agree)."""
        c = self.cfg
        w = params["embed"].T if c.tie_embeddings else params["lm_head"]
        if compute_dtype is not None:
            w = w.to(compute_dtype)
        elif weight_dtype is not None:
            w = w.to(weight_dtype).to(hidden.dtype)
        out = hidden @ w
        if c.embed_scale != 1.0:
            out = out * c.embed_scale
        if c.logit_soft_cap > 0:
            out = torch.tanh(out / c.logit_soft_cap) * c.logit_soft_cap
        if out.dim() == 3:
            out = constrain(out, ("batch", None, "vocab"))
        return out

    def _qkv(self, lp, h: torch.Tensor, positions: torch.Tensor,
             mm=torch.matmul):
        """Projections of the normed input h [..., D] into q [..., Hq, hd]
        and k, v [..., Hkv, hd] by the product ``mm``, with qk-norm and
        RoPE at ``positions`` (shaped like ``h`` without its last dim)."""
        c = self.cfg
        q = split_heads(mm(h, lp["wq"]), c.num_heads, c.head_dim)
        k = split_heads(mm(h, lp["wk"]), c.num_kv_heads, c.head_dim)
        v = split_heads(mm(h, lp["wv"]), c.num_kv_heads, c.head_dim)
        if c.qk_norm:
            q = rms_norm(q, lp["q_norm"], c.norm_eps)
            k = rms_norm(k, lp["k_norm"], c.norm_eps)
        return (apply_rope(q, positions, c.rope_theta),
                apply_rope(k, positions, c.rope_theta), v)

    @staticmethod
    def _constrain_qkv(q, k, v, head_sharded: bool):
        """The reference's constraints on a block's q/k/v ``[B, S, H, hd]``
        (``transformer.py:157-163``): heads over the model axis, or, where
        the head count does not divide it, q over the sequence."""
        if head_sharded:
            lg = ("batch", None, "act_heads", None)
            return constrain(q, lg), constrain(k, lg), constrain(v, lg)
        return constrain(q, ("batch", "seq", None, None)), k, v

    def _mixer_residual(self, lp, x: torch.Tensor, attn_out: torch.Tensor,
                        ssm_out: Optional[torch.Tensor]) -> torch.Tensor:
        """x plus the token mixer's output: the attention branch alone, or
        under ``hybrid`` the mean of the attention and SSM branches, each
        RMS-normed (``ssm_out``). Over a mesh the training and prefill
        paths constrain the sum to the layer's output placements: DTensor,
        unlike GSPMD, would keep the tensor-parallel partial sum and
        scatter it along the sequence, which the MLP's product then cannot
        shard."""
        c = self.cfg
        if ssm_out is None:
            return x + attn_out * c.residual_scale
        mixed = 0.5 * (rms_norm(attn_out, lp["attn_branch_norm"], c.norm_eps)
                       + rms_norm(ssm_out, lp["ssm_branch_norm"], c.norm_eps))
        return x + mixed * c.residual_scale

    def _mlp_residual(self, lp, x: torch.Tensor,
                      capacity_factor: float = SERVE_CAPACITY_FACTOR,
                      mm=torch.matmul) -> Tuple[torch.Tensor, torch.Tensor]:
        """The FFN block over x [..., D]: ``(x + its output, aux)``, ``aux``
        the MoE load-balancing loss (a float32 zero under a dense FFN). A
        ``moe`` layer routes all of x's rows in one call, as every path of
        the reference does (capacity is per call, so the rows decide each
        other's drops), with its own products; a dense FFN's products are
        ``mm``."""
        c = self.cfg
        h2 = rms_norm(x, lp["ln2"], c.norm_eps)
        if c.family == "moe":
            out, aux = moe_lib.moe_ffn(
                lp["moe"], h2.reshape(-1, c.d_model), c,
                capacity_factor=capacity_factor, return_aux=True)
            out = out.reshape(x.shape)
        else:
            out = mlp_apply(lp["mlp"], h2, c.act, mm)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + out * c.residual_scale, aux

    # ------------------------------------------------------------------
    # training: full forward and loss
    # ------------------------------------------------------------------
    def _train_layer(self, lp, x: torch.Tensor, positions: torch.Tensor,
                     window: int, head_sharded: bool = True):
        """One block in its training form: ``(x, aux)``, ``aux`` the MoE
        load-balancing loss of the layer (float32 zero elsewhere). The
        reference's ``_layer`` without a KV writer."""
        c = self.cfg
        b, s, _ = x.shape
        h = rms_norm(x, lp["ln1"], c.norm_eps)
        q, k, v = self._constrain_qkv(*self._qkv(lp, h, positions),
                                      head_sharded)
        out = attn.dense_or_blockwise(q, k, v, positions, positions,
                                      causal=True, window=window)
        out = out.reshape(b, s, c.q_dim)
        if head_sharded:
            out = constrain(out, ("batch", None, "act_ff"))
        attn_out, ssm_out = out @ lp["wo"], None
        if c.family == "hybrid":
            # both branches' partial sums reduced before their norms
            rows = ("batch", None, "embed")
            attn_out = constrain(attn_out, rows)
            ssm_out = constrain(ssm_lib.mamba_forward(lp["ssm"], h), rows)
        x = constrain(self._mixer_residual(lp, x, attn_out, ssm_out),
                      ("batch", None, "embed"))
        x, aux = self._mlp_residual(lp, x, TRAIN_CAPACITY_FACTOR)
        return constrain(x, ("batch", None, "embed")), aux

    def forward(self, params, tokens: torch.Tensor,
                img_embeds: Optional[torch.Tensor] = None, *,
                compute_dtype=torch.bfloat16, remat: str = "full",
                tp_size: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training forward of ``tokens [B, S_text]`` (after the image
        under ``vlm``): ``(final hidden [B, S, D] in compute_dtype, total
        aux loss)``. Every parameter is cast to ``compute_dtype`` first;
        ``remat`` is one of ``layers.REMAT``, applied to each layer.
        Attention takes the reference's head-sharded constraints where the
        heads divide ``tp_size`` (its ``head_sharded``)."""
        c = self.cfg
        head_sharded = c.num_heads % max(tp_size, 1) == 0
        p = tree_map(lambda a: a.to(compute_dtype), params)
        x = self.embed(self._gathered(p), tokens, img_embeds)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        x = constrain(x, ("batch", None, "embed"))
        layers = unstack(p["layers"])
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for grp in layer_groups(c):
            auxs = []
            for lp in layers[grp.start:grp.end]:
                def layer(xx, lp=lp, window=grp.window):
                    return self._train_layer(self._gathered(lp, True), xx,
                                             positions, window, head_sharded)
                x, aux = remat_call(layer, x, remat)
                auxs.append(aux)
            aux_total = aux_total + torch.stack(auxs).sum()
        return rms_norm(x, p["final_norm"], c.norm_eps), aux_total

    def _gathered(self, p, layer: bool = False):
        """Parameters as a training step computes with them over a mesh:
        the top-level ones (``layer=False``: the layer stack is left out)
        or one layer's, their FSDP shards gathered
        (``common.sharding.gather_fsdp``) one layer at a time, inside the
        layer's remat region, so that its backward gathers again, as FSDP
        does. The MoE experts are left to the expert-parallel path, which
        gathers them itself. Plain tensors pass unchanged."""
        axes = self.param_axes()
        axes = tree_map(lambda ax: ax[1:], axes["layers"]) if layer else axes
        keep = {k for k in p if k not in ("layers", "moe")}
        out = gather_fsdp({k: p[k] for k in keep}, {k: axes[k] for k in keep})
        if "moe" in p:
            out["moe"] = p["moe"]
        return out

    def loss_fn(self, params, batch: Dict[str, torch.Tensor], *,
                remat: str = "full", tp_size: int = 1
                ) -> Tuple[torch.Tensor, Dict]:
        """batch: tokens [B, S], labels [B, S] (-1 = masked), and under
        ``vlm`` img_embeds [B, img_tokens, D]. Returns ``(total, metrics)``:
        the masked NLL plus a z-loss of ``1e-4 * lse**2`` plus
        ``router_aux_coef * aux``; the image prefix carries no loss. The
        head is a bfloat16 product (:meth:`logits` with
        ``compute_dtype``), then widened to float32."""
        hidden, aux = self.forward(params, batch["tokens"],
                                   img_embeds=batch.get("img_embeds"),
                                   remat=remat, tp_size=tp_size)
        return self.head_loss(params, hidden, batch["labels"], aux)

    def head_loss(self, params, hidden: torch.Tensor, labels: torch.Tensor,
                  aux: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """:meth:`loss_fn` past the forward: the head and the losses of
        ``hidden`` (the forward's output) against ``labels``."""
        c = self.cfg
        if c.family == "vlm":  # img prefix carries no loss
            hidden = hidden[:, hidden.shape[1] - labels.shape[1]:]
        logits = self.logits(params, hidden,
                             compute_dtype=torch.bfloat16).float()
        loss, lse, mask, ntok = masked_nll(logits, labels)
        zloss = 1e-4 * (lse.square() * mask).sum() / ntok
        total = loss + zloss + c.router_aux_coef * aux
        return total, {"loss": loss, "zloss": zloss, "aux": aux,
                       "ntok": ntok}

    # ------------------------------------------------------------------
    # serving: Libra fast path (paged, anchored)
    # ------------------------------------------------------------------
    def kv_pool_shape(self, total_pages: int) -> Tuple[int, ...]:
        c = self.cfg
        return (c.num_layers, total_pages, self.page_size, 2, c.num_kv_heads,
                c.head_dim)

    def ssm_state_shapes(self, batch: int) -> Dict[str, Tuple[int, ...]]:
        """The ``hybrid`` decode state of ``batch`` rows: every layer's
        Mamba state (``ssm_lib.mamba_state_shape``), layers leading."""
        c = self.cfg
        shapes = ssm_lib.mamba_state_shape(c.d_model, c.ssm_state, c.ssm_conv,
                                           c.ssm_expand)
        return {k: (c.num_layers, batch) + s for k, s in shapes.items()}

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
        *,
        ssm_state: Optional[Dict[str, torch.Tensor]] = None,  # hybrid only
        mesh=None,
        batch_axis=None,
        combine_axes=(),
    ) -> torch.Tensor:
        """One Libra decode step. Returns next_tokens [B] int32; the pool
        is updated in place.

        With a ``mesh`` the paged attention is the flash-decode region
        over ``combine_axes`` (``attention.paged_decode_attention``); the
        inputs are DTensors (or this rank's shards) placed as the
        reference's dry-run places them.

        Under ``hybrid`` (and only then) ``ssm_state`` is required:
        ``{"ssm": [L, B, d_inner, n], "conv": [L, B, K-1, d_inner]}``
        (:meth:`ssm_state_shapes`), each row the Mamba state of the batch
        row it stands beside. The step advances it *in place*, where the
        JAX model returns a new state (as ``XLSTMModel.decode_step`` does).

        Host<->device traffic: token ids + O(pages) int32 metadata in;
        token ids out. The KV payload never leaves the pool."""
        c = self.cfg
        hybrid = c.family == "hybrid"
        if (ssm_state is not None) != hybrid:
            raise ValueError(f"{c.name}: ssm_state is for the hybrid "
                             "family's decode step, and it needs one")
        with span("model.decode_step"), use_mesh(mesh):
            x = embed_lookup(params["embed"], tokens)     # [B, D]
            b = x.shape[0]
            mesh_kw = dict(mesh=mesh, batch_axis=batch_axis,
                           combine_axes=combine_axes)
            mesh_kw["write_index"] = attn.decode_write_index(
                tables, page_pos, seq_lens, write_shard, write_slot,
                pool.shape[2], **mesh_kw)
            for li in range(c.num_layers):
                lp = layer_params(params, li)
                h = rms_norm(x, lp["ln1"], c.norm_eps)
                q, k, v = self._qkv(lp, h[:, None], seq_lens[:, None])
                out = attn.paged_decode_attention(
                    q[:, 0], k[:, 0], v[:, 0], pool[li], tables, page_pos,
                    seq_lens, write_shard, write_slot,
                    window=self.windows[li], impl=self.attn_impl, **mesh_kw)
                ssm_out = None
                if hybrid:
                    ssm_out, st = ssm_lib.mamba_step(
                        lp["ssm"], h,
                        {key: t[li] for key, t in ssm_state.items()})
                    for key, val in st.items():
                        ssm_state[key][li].copy_(val)
                x = self._mixer_residual(lp, x, out.reshape(b, c.q_dim)
                                         @ lp["wo"], ssm_out)
                x, _aux = self._mlp_residual(lp, x)
            x = rms_norm(x, params["final_norm"], c.norm_eps)
            return argmax_last(self.logits(
                params, x, weight_dtype=torch.bfloat16)).to(torch.int32)

    @torch.no_grad()
    def prefill(
        self,
        params,
        tokens: torch.Tensor,       # [B, S]
        seq_lens: torch.Tensor,     # [B]
        pool: torch.Tensor,         # [L, P, page, 2, Hkv, hd], updated in place
        tables: torch.Tensor,       # [B, n_shards, pps]
        token_shard: torch.Tensor,  # [B, S]
        token_slot: torch.Tensor,
        token_off: torch.Tensor,
        token_valid: torch.Tensor,
        *,
        img_embeds: Optional[torch.Tensor] = None,  # vlm only
        mesh=None,
        batch_axis=None,
        combine_axes=(),
        tp_size: int = 1,
    ) -> torch.Tensor:
        """Ingress: run the prompt, anchor its KV into pool pages in place,
        return the first sampled tokens [B] int32. Only token ids ever
        surface to the host. With a ``mesh`` each rank anchors the pages
        of its shard of ``combine_axes``, and attention runs head-parallel
        where the heads divide ``tp_size`` (the reference's
        ``head_sharded``). Under ``hybrid`` the Mamba mixers' final
        states are dropped, as in the JAX model: prefill writes no
        ``ssm_state``, so a request's decode starts from whatever its
        batch row holds (a fault of the reference, carried).

        Under ``vlm`` the prompt is the image's ``img_tokens`` positions
        (``img_embeds [B, img_tokens, D]``, see :meth:`embed`) and then
        ``tokens [B, S_text]``: the token coordinates ``token_shard`` ...
        ``token_valid`` span ``[B, img_tokens + S_text]``, and all of it
        is anchored. ``seq_lens`` counts text tokens only; the first token
        is sampled at position ``img_tokens + seq_lens - 1``, as in the
        JAX model. The decode steps that follow take the prefix-inclusive
        position: ``seq_lens`` there is ``img_tokens + text_len + i`` for
        the ``i``-th step, so that they read the image's anchored pages
        and each token's K/V lands past them."""
        with span("model.prefill"), use_mesh(mesh):
            return self._prefill(params, tokens, seq_lens, pool, tables,
                                 token_shard, token_slot, token_off,
                                 token_valid, img_embeds, mesh, batch_axis,
                                 combine_axes, tp_size)

    def _prefill_mm(self, mesh=None):
        """The product of the prefill's per-layer projections:
        ``ops.linear_f32`` at ``attn_impl`` (the split-TF32 kernel on CUDA
        tensors), or ``torch.matmul`` over a mesh, whose DTensors the
        kernel does not take."""
        if mesh is not None:
            return torch.matmul
        return functools.partial(ops.linear_f32, impl=self.attn_impl)

    def _prefill(self, params, tokens, seq_lens, pool, tables, token_shard,
                 token_slot, token_off, token_valid, img_embeds, mesh,
                 batch_axis, combine_axes, tp_size: int) -> torch.Tensor:
        c = self.cfg
        mm = self._prefill_mm(mesh)
        head_sharded = c.num_heads % max(tp_size, 1) == 0
        x = self.embed(params, tokens, img_embeds)              # [B, S, D]
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        x = constrain(x, ("batch", None, "embed"))
        write_kw = dict(mesh=mesh, batch_axis=batch_axis,
                        combine_axes=combine_axes)
        write_kw["write_index"] = attn.prefill_write_index(
            tables, token_shard, token_slot, token_off, token_valid,
            **write_kw)
        for li in range(c.num_layers):
            lp = layer_params(params, li)
            h = rms_norm(x, lp["ln1"], c.norm_eps)
            q, k, v = self._constrain_qkv(*self._qkv(lp, h, positions, mm),
                                          head_sharded)
            attn.prefill_write_pages(k, v, pool[li], tables, token_shard,
                                     token_slot, token_off, token_valid,
                                     **write_kw)
            out = attn.prefill_attention(q, k, v, window=self.windows[li],
                                         impl=self.attn_impl)
            out = out.reshape(b, s, c.q_dim)
            if head_sharded:
                out = constrain(out, ("batch", None, "act_ff"))
            ssm_out = (ssm_lib.mamba_forward(lp["ssm"], h)
                       if c.family == "hybrid" else None)
            x = constrain(self._mixer_residual(lp, x, mm(out, lp["wo"]),
                                               ssm_out),
                          ("batch", None, "embed"))
            x, _aux = self._mlp_residual(lp, x, mm=mm)
            x = constrain(x, ("batch", None, "embed"))
        # sample the first output token from the last valid position
        idx = (seq_lens.long() - 1).clamp(min=0) + (s - tokens.shape[1])
        last = x[torch.arange(b, device=x.device), idx]         # [B, D]
        last = rms_norm(last, params["final_norm"], c.norm_eps)
        return argmax_last(self.logits(params, last)).to(torch.int32)

    # ------------------------------------------------------------------
    # serving baseline: the "standard stack" contiguous-copy datapath
    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill_dense(self, params, tokens: torch.Tensor,
                      seq_lens: torch.Tensor, max_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Baseline prefill: returns (first_tokens [B] int32, kv_cache
        [L, B, max_len, 2, Hkv, hd]) -- the contiguous cache the standard
        stack re-copies every step, zero past the prompt's ``S`` tokens.
        Attention takes the route of :meth:`prefill`, but, as in the JAX
        model, global on every layer and with no SSM branch under
        ``hybrid``: the baselines serve another model than
        ``LibraEngine`` there (a fault of the reference, carried). Under
        ``vlm`` it takes no image, as in the JAX model, and so serves the
        text-only model (carried too)."""
        c = self.cfg
        mm = self._prefill_mm()
        x = embed_lookup(params["embed"], tokens)                      # [B, S, D]
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        kv = x.new_zeros((c.num_layers, b, max_len, 2, c.num_kv_heads,
                          c.head_dim))
        for li in range(c.num_layers):
            lp = layer_params(params, li)
            h = rms_norm(x, lp["ln1"], c.norm_eps)
            q, k, v = self._qkv(lp, h, positions, mm)
            kv[li, :, :s, 0] = k
            kv[li, :, :s, 1] = v
            out = attn.prefill_attention(q, k, v, impl=self.attn_impl)
            x = x + mm(out.reshape(b, s, c.q_dim), lp["wo"]) * c.residual_scale
            x, _aux = self._mlp_residual(lp, x, mm=mm)
        idx = (seq_lens.long() - 1).clamp(min=0)
        last = x[torch.arange(b, device=x.device), idx]         # [B, D]
        last = rms_norm(last, params["final_norm"], c.norm_eps)
        return argmax_last(self.logits(params, last)).to(torch.int32), kv

    @torch.no_grad()
    def decode_step_dense(self, params, tokens: torch.Tensor,
                          seq_lens: torch.Tensor, cache: torch.Tensor, *,
                          donate: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Standard-stack analogue over the contiguous cache ``[L, B, Smax,
        2, Hkv, hd]``: write the incoming token's K/V at ``seq_lens``,
        attend over positions ``<= seq_lens``, and return (FULL float32
        logits [B, V], cache).

        Undonated, the step first copies the whole cache into a new tensor
        and writes that one (the JAX package's undonated update makes XLA
        materialise a fresh cache: the standard stack's per-message payload
        copy, which the engines count); ``donate=True`` writes ``cache`` in
        place and returns it. The head's weights are rounded to bfloat16,
        as in :meth:`decode_step`. No window and no SSM branch, as in
        :meth:`prefill_dense`."""
        c = self.cfg
        if not donate:
            cache = cache.clone()
        x = embed_lookup(params["embed"], tokens)                      # [B, D]
        b, smax = x.shape[0], cache.shape[2]
        rows = torch.arange(b, device=x.device)
        # dynamic_update_slice clamps the start so that the update fits
        wpos = seq_lens.long().clamp(0, smax - 1)
        pos_kv = torch.arange(smax, device=x.device).expand(b, smax)
        valid = pos_kv <= seq_lens[:, None]
        for li in range(c.num_layers):
            lp = layer_params(params, li)
            h = rms_norm(x, lp["ln1"], c.norm_eps)
            q, k, v = self._qkv(lp, h[:, None], seq_lens[:, None])
            cache_l = cache[li]                                 # [B, Smax, ...]
            cache_l[rows, wpos] = torch.stack([k[:, 0], v[:, 0]],
                                              dim=1).to(cache.dtype)
            out = attn.dense_attention(q, cache_l[:, :, 0], cache_l[:, :, 1],
                                       seq_lens[:, None], pos_kv,
                                       causal=False, kv_valid=valid)[:, 0]
            x = x + (out.reshape(b, c.q_dim) @ lp["wo"]) * c.residual_scale
            x, _aux = self._mlp_residual(lp, x)
        x = rms_norm(x, params["final_norm"], c.norm_eps)
        return self.logits(params, x, weight_dtype=torch.bfloat16), cache
