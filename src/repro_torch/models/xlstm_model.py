"""xLSTM language model (xlstm-350m): mLSTM and sLSTM blocks, serving path.

PyTorch twin of the JAX package's ``repro.models.xlstm_model``. The model
is attention-free: what a prompt leaves behind is the recurrent state
(matrix memory ``C``, ``n``, ``m`` and the conv window per mLSTM block,
scalar cells per sLSTM block), and a decode step is O(1) in the context
length. ``prefill`` runs every mLSTM block's chunkwise scan through
``ops.mlstm_scan`` (the CUDA kernel on the card, ``mlstm_impl='ref'`` for
the plain chunked version anywhere) and keeps the final states;
``decode_step`` advances them one token. Parameters are the JAX package's
nested dict, the blocks of each kind stacked on a leading axis; blocks run
in position order in a Python loop over contiguous runs (the JAX package
scans each run). Computation is float32.

Differences from the JAX model, each deliberate: ``decode_step`` updates
the decode state in place (JAX returns a new tree); prefill computes the
conv window from the last ``K-1`` positions only, the rows the JAX model
slices from its full-length recomputation. ``decode_step`` rounds the
head's weights to bfloat16, as the JAX model's does (see ``logits``).

Training (:meth:`XLSTMModel.forward`, :meth:`XLSTMModel.loss_fn`) casts
every parameter to bfloat16 first, as the reference does, runs each
mLSTM block's scan through ``ssm.mlstm_cell_chunked`` (the kernel is
forward only) and rematerialises each block by ``remat``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.common.sharding import constrain, is_distributed
from repro_torch.common.types import ModelConfig
from repro_torch.kernels.ops import IMPLS
from repro_torch.models.layers import (
    ParamSpec,
    abstract_params,
    argmax_last,
    count_template_params,
    embed_lookup,
    init_params,
    masked_nll,
    param_axes,
    remat_call,
    rms_norm,
    tree_map,
    unstack,
)
from repro_torch.models.ssm import (
    NEG_INF,
    mlstm_block_forward,
    mlstm_block_step,
    mlstm_block_template,
    mlstm_block_train,
    slstm_block_forward,
    slstm_block_step,
    slstm_block_template,
)
from repro_torch.models.transformer import stack_template

_M_KEYS = ("m_C", "m_n", "m_m", "m_conv")
_S_KEYS = ("s_c", "s_n", "s_m", "s_h")


def block_kinds(cfg: ModelConfig) -> List[str]:
    """Position i is sLSTM iff (i + 1) % slstm_every == 0 (xLSTM[7:1])."""
    k = []
    for i in range(cfg.num_layers):
        if cfg.slstm_every and (i + 1) % cfg.slstm_every == 0:
            k.append("slstm")
        else:
            k.append("mlstm")
    return k


def runs(kinds: List[str]) -> List[Tuple[str, int, int]]:
    """Contiguous (kind, start_within_kind_stack, length) runs in order."""
    out = []
    idx = {"mlstm": 0, "slstm": 0}
    i = 0
    while i < len(kinds):
        j = i
        while j < len(kinds) and kinds[j] == kinds[i]:
            j += 1
        out.append((kinds[i], idx[kinds[i]], j - i))
        idx[kinds[i]] += j - i
        i = j
    return out


def _blocks(kinds: List[str]):
    """(kind, index within its stack) of every block, in position order."""
    for kind, start, length in runs(kinds):
        for i in range(start, start + length):
            yield kind, i


class XLSTMModel:
    def __init__(self, cfg: ModelConfig, mlstm_impl: str = "auto"):
        if mlstm_impl not in IMPLS:
            raise ValueError(f"unknown mlstm_impl {mlstm_impl!r} (expected "
                             f"one of {IMPLS})")
        self.cfg = cfg
        #: ``ops`` impl of the mLSTM scan: 'auto' runs the CUDA kernel on
        #: CUDA tensors, 'ref' the plain chunked version anywhere
        self.mlstm_impl = mlstm_impl
        self.kinds = block_kinds(cfg)
        self.n_mlstm = self.kinds.count("mlstm")
        self.n_slstm = self.kinds.count("slstm")

    # -- params -----------------------------------------------------------
    def template(self) -> Dict:
        c = self.cfg
        t = {
            "embed": ParamSpec((c.vocab_size, c.d_model), ("tensor", None),
                               fan_in_dims=(1,)),
            "final_norm": ParamSpec((c.d_model,), (None,), init="zeros"),
            "lm_head": ParamSpec((c.d_model, c.vocab_size),
                                 ("fsdp", "tensor")),
            "mlstm": stack_template(
                mlstm_block_template(c.d_model, c.num_heads, c.ssm_conv,
                                     c.ssm_expand), self.n_mlstm),
        }
        if self.n_slstm:
            t["slstm"] = stack_template(
                slstm_block_template(c.d_model, c.num_heads), self.n_slstm)
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

    def logits(self, params, hidden: torch.Tensor, weight_dtype=None,
               compute_dtype=None) -> torch.Tensor:
        """Logits of ``hidden``. With ``compute_dtype`` (training's
        bfloat16) the head's weights are cast to it and the product runs
        in it. With ``weight_dtype`` the head's weights are only rounded
        to that dtype (and computed with in ``hidden``'s).
        ``decode_step`` passes bfloat16: the JAX model's calls ``logits``
        without ``compute_dtype``, whose default is bfloat16 (a fault of
        the reference, carried so that tokens agree; ``prefill`` passes
        its compute dtype there and stays float32)."""
        w = params["lm_head"]
        if compute_dtype is not None:
            w = w.to(compute_dtype)
        elif weight_dtype is not None:
            w = w.to(weight_dtype).to(hidden.dtype)
        out = hidden @ w
        if out.dim() == 3:
            out = constrain(out, ("batch", None, "vocab"))
        return out

    # -- over a mesh ----------------------------------------------------------
    @staticmethod
    def _batch_local(fn, params, args, arg_dims, out_dims):
        """``fn(params, *args)`` on this rank's batch rows: the DTensor
        parameters gathered whole (their gradient partial over the batch
        axes), each DTensor of ``args`` (a tensor or a dict of them) taken
        at its batch shard along ``arg_dims``, and each of the outputs
        wrapped back with its batch along ``out_dims`` (``None``:
        replicated). The blocks' scans, gates and state updates have no
        DTensor strategy, so the family runs data-parallel over a mesh,
        the batch split as the first argument's is (the reference lets
        GSPMD split it)."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        mesh = args[0].device_mesh
        baxes = {i for i, p in enumerate(args[0].placements)
                 if isinstance(p, Shard) and p.dim == 0}

        def pl(d):
            return [Shard(d) if d is not None and i in baxes else Replicate()
                    for i in range(mesh.ndim)]

        grad = [Partial() if i in baxes else Replicate()
                for i in range(mesh.ndim)]

        def local(a, d, grad_pl=None):
            if not isinstance(a, DTensor):
                return a
            a = a.redistribute(mesh, pl(d))
            return a.to_local(grad_placements=grad_pl)

        lp = tree_map(lambda a: local(a, None, grad), params)
        la = [tree_map(lambda a, d=d: local(a, d), arg)
              for arg, d in zip(args, arg_dims)]
        out = fn(lp, *la)
        return tuple(tree_map(lambda o, d=d: DTensor.from_local(
            o, mesh, pl(d), run_check=False), o_)
            for o_, d in zip(out, out_dims))

    # -- training ------------------------------------------------------------
    def forward(self, params, tokens: torch.Tensor, *,
                compute_dtype=torch.bfloat16, remat: str = "full"):
        """Training forward: ``(final hidden [B, S, D] in compute_dtype,
        aux)``, ``aux`` a float32 zero (no router). Blocks run in position
        order, each under ``remat``. On DTensors, per rank on its batch
        rows (:meth:`_batch_local`)."""
        if is_distributed(tokens):
            return self._batch_local(
                lambda p, t: self.forward(p, t, compute_dtype=compute_dtype,
                                          remat=remat),
                params, (tokens,), (0,), (0, None))
        c = self.cfg
        p = tree_map(lambda a: a.to(compute_dtype), params)
        x = embed_lookup(p["embed"], tokens)
        x = constrain(x, ("batch", None, "embed"))
        stacks = {kind: unstack(p[kind])
                  for kind in ("mlstm", "slstm") if kind in p}
        for kind, i in _blocks(self.kinds):
            lp = stacks[kind][i]
            if kind == "mlstm":
                def block(xx, lp=lp):
                    return mlstm_block_train(lp, xx, c)
            else:
                def block(xx, lp=lp):
                    return slstm_block_forward(lp, xx, c)
            x = remat_call(block, x, remat)
        x = rms_norm(x, p["final_norm"], c.norm_eps)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def loss_fn(self, params, batch: Dict[str, torch.Tensor], *,
                remat: str = "full", tp_size: int = 1):
        """The masked next-token NLL of ``batch`` (tokens, labels; -1 =
        masked), with no z-loss, as the reference's. The head is a
        bfloat16 product widened to float32. ``tp_size`` is taken for the
        trainer's sake and unused, as in the reference."""
        hidden, _ = self.forward(params, batch["tokens"], remat=remat)
        logits = self.logits(params, hidden,
                             compute_dtype=torch.bfloat16).float()
        loss, _lse, _mask, ntok = masked_nll(logits, batch["labels"])
        return loss, {"loss": loss, "ntok": ntok}

    # -- serving -----------------------------------------------------------
    def decode_state_shapes(self, batch: int) -> Dict[str, Tuple[int, ...]]:
        c = self.cfg
        ud = c.ssm_expand * c.d_model
        dh_m = ud // c.num_heads
        dh_s = c.d_model // c.num_heads
        shapes = {
            "m_C": (self.n_mlstm, batch, c.num_heads, dh_m, dh_m),
            "m_n": (self.n_mlstm, batch, c.num_heads, dh_m),
            "m_m": (self.n_mlstm, batch, c.num_heads),
            "m_conv": (self.n_mlstm, batch, c.ssm_conv - 1, ud),
        }
        if self.n_slstm:
            shapes.update({k: (self.n_slstm, batch, c.num_heads, dh_s)
                           for k in _S_KEYS})
        return shapes

    def init_decode_state(self, batch: int, *, device="cuda"
                          ) -> Dict[str, torch.Tensor]:
        shapes = self.decode_state_shapes(batch)
        st = {k: torch.zeros(s, dtype=torch.float32, device=device)
              for k, s in shapes.items()}
        st["m_m"].fill_(NEG_INF)
        if self.n_slstm:
            st["s_m"].fill_(NEG_INF)
        return st

    @torch.no_grad()
    def decode_step(self, params, tokens: torch.Tensor,
                    seq_lens: torch.Tensor, state: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """O(1) decode: recurrent state in, token ids out. ``state`` is
        updated in place and returned. ``seq_lens`` is unused, as in the
        JAX model (the state carries the position). On DTensors, per rank
        on its batch rows (:meth:`_batch_local`; the state's batch is its
        dim 1)."""
        if is_distributed(tokens):
            return self._batch_local(self.decode_step, params,
                                     (tokens, seq_lens, state), (0, 0, 1),
                                     (0, 1))
        del seq_lens
        c = self.cfg
        x = embed_lookup(params["embed"], tokens)                      # [B, D]
        for kind, i in _blocks(self.kinds):
            lp = tree_map(lambda a: a[i], params[kind])
            if kind == "mlstm":
                x, st = mlstm_block_step(lp, x, c, {
                    "C": state["m_C"][i], "n": state["m_n"][i],
                    "m": state["m_m"][i], "conv": state["m_conv"][i]})
                keys = zip(_M_KEYS, ("C", "n", "m", "conv"))
            else:
                x, st = slstm_block_step(lp, x, c, {
                    "c": state["s_c"][i], "n": state["s_n"][i],
                    "m": state["s_m"][i], "h": state["s_h"][i]})
                keys = zip(_S_KEYS, ("c", "n", "m", "h"))
            for skey, key in keys:
                state[skey][i].copy_(st[key])
        x = rms_norm(x, params["final_norm"], c.norm_eps)
        next_tokens = argmax_last(self.logits(
            params, x, weight_dtype=torch.bfloat16)).to(torch.int32)
        return next_tokens, state

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, seq_lens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Run the prompts ``tokens [B, S]`` once, keeping every block's
        final state. Returns ``(first_tokens [B] int32, decode_state)``.

        As in the JAX model, the state (the conv window included) is the
        one at the end of the padded batch, not at each row's
        ``seq_lens``; only the first token is read at ``seq_lens - 1``.
        On DTensors, per rank on its batch rows (:meth:`_batch_local`)."""
        if is_distributed(tokens):
            return self._batch_local(self.prefill, params, (tokens, seq_lens),
                                     (0, 0), (0, 1))
        c = self.cfg
        b = tokens.shape[0]
        x = embed_lookup(params["embed"], tokens)                      # [B, S, D]
        state = self.init_decode_state(b, device=x.device)
        for kind, i in _blocks(self.kinds):
            lp = tree_map(lambda a: a[i], params[kind])
            if kind == "mlstm":
                x_in = x
                x, (C, n, m) = mlstm_block_forward(lp, x_in, c,
                                                   return_state=True,
                                                   impl=self.mlstm_impl)
                state["m_C"][i] = C
                state["m_n"][i] = n
                state["m_m"][i] = m
                # conv state: last K-1 inputs of the up-projected stream
                ud = lp["conv_w"].shape[1]
                tail = rms_norm(x_in[:, -(c.ssm_conv - 1):], lp["ln_w"], 1e-5)
                state["m_conv"][i] = tail @ lp["up_proj"][:, :ud]
            else:
                x, st = slstm_block_forward(lp, x, c, return_state=True)
                for skey, val in zip(_S_KEYS, st):
                    state[skey][i] = val
        idx = (seq_lens.long() - 1).clamp(min=0)
        last = x[torch.arange(b, device=x.device), idx]         # [B, D]
        last = rms_norm(last, params["final_norm"], c.norm_eps)
        first = argmax_last(self.logits(params, last)).to(torch.int32)
        return first, state
