"""State-space / recurrent mixers: Mamba (hymba), mLSTM + sLSTM (xlstm).

PyTorch twins of the JAX package's ``repro.models.ssm``.

The Mamba mixer (``hybrid`` family) keeps the reference's chunked form:
``selective_scan_chunked`` walks chunks of 128 positions in a Python loop
and scans each chunk with a log-depth doubling scan under the reference's
combine ``(a0, b0) . (a1, b1) = (a1 a0, a1 b0 + b1)`` (7 steps at 128),
each step written into new tensors. So at most ``[B, chunk, d_inner, n]``
is held at once, never ``[B, S, d_inner, n]``, and no loop runs over
positions. The reference's scan is jnp (``lax.associative_scan`` inside a
``lax.scan``), with no TPU kernel behind it; the port's is plain PyTorch
too. The two scans add in another order, so they agree to float32
rounding, not bit for bit. ``mamba_forward`` drops the scan's final state,
as the reference's does: prefill leaves no SSM state behind (a fault of
the reference, carried; see ``TransformerLM.decode_step``).

One deliberate difference in the mLSTM: the serving block
``mlstm_block_forward`` runs its chunkwise scan through
``ops.mlstm_scan(..., return_state=True)`` (the CUDA kernel on a CUDA
tensor; on the CPU its plain version, which is :func:`mlstm_cell_chunked`
in the kernel's layout), where the JAX function
calls its jnp ``mlstm_cell_chunked`` and no caller reaches the Pallas
kernel. The serving scan starts from the zero state: the JAX function's
``state=`` argument has no caller and is not carried. Training's block,
``mlstm_block_train``, calls the port's ``mlstm_cell_chunked`` as the
reference does: the kernel is forward only.
``_slstm_scan`` is a sequential recurrence with no TPU kernel behind it
and stays a plain loop.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.sharding import constrain, is_distributed
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    ParamSpec,
    causal_conv1d,
    conv1d_step,
    gelu,
    group_norm,
    rms_norm,
)

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Mamba (selective SSM) -- used by hymba's parallel SSM heads
# ---------------------------------------------------------------------------


def mamba_template(d_model: int, ssm_state: int, conv: int,
                   expand: int) -> Dict:
    d_inner = expand * d_model
    dt_rank = -(-d_model // 16)
    return {
        "in_proj": ParamSpec((d_model, 2 * d_inner), ("fsdp", "tensor")),
        "conv_w": ParamSpec((conv, d_inner), ("conv", "tensor")),
        "conv_b": ParamSpec((d_inner,), ("tensor",), init="zeros"),
        "x_proj": ParamSpec((d_inner, dt_rank + 2 * ssm_state),
                            ("tensor", None)),
        "dt_proj": ParamSpec((dt_rank, d_inner), (None, "tensor")),
        "dt_bias": ParamSpec((d_inner,), ("tensor",), init="zeros"),
        "A_log": ParamSpec((d_inner, ssm_state), ("tensor", "state"),
                           init="zeros"),
        "D": ParamSpec((d_inner,), ("tensor",), init="ones"),
        "out_proj": ParamSpec((d_inner, d_model), ("tensor", "fsdp")),
    }


def _mamba_gates(p, u):
    """u [B,*,d_inner] -> (dt [B,*,d_inner], Bc [B,*,n], Cc [B,*,n])."""
    n = p["A_log"].shape[1]
    dt_rank = p["x_proj"].shape[1] - 2 * n
    proj = u @ p["x_proj"]
    dt = F.softplus(proj[..., :dt_rank] @ p["dt_proj"] + p["dt_bias"])
    return dt, proj[..., dt_rank: dt_rank + n], proj[..., dt_rank + n:]


def _doubling_scan(a: torch.Tensor, b: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the pairs ``(a[:, t], b[:, t])`` along dim 1 under
    ``(a0, b0) . (a1, b1) = (a1 a0, a1 b0 + b1)``: after it, ``b[:, t]`` is
    the state at ``t`` from a zero start and ``a[:, t]`` the product of the
    decays up to ``t``. Each doubling step reads the last step's tensors
    and writes new ones (nothing in place, so autograd differentiates it):
    log2(len) steps."""
    n = a.shape[1]
    d = 1
    while d < n:
        a, b = (torch.cat([a[:, :d], torch.mul(a[:, d:], a[:, :-d])], dim=1),
                torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:],
                                                   b[:, :-d])], dim=1))
        d *= 2
    return a, b


def selective_scan_chunked(
    u: torch.Tensor,    # [B, S, d]
    dt: torch.Tensor,   # [B, S, d]
    Bc: torch.Tensor,   # [B, S, n]
    Cc: torch.Tensor,   # [B, S, n]
    A: torch.Tensor,    # [d, n]  (negative)
    h0: Optional[torch.Tensor] = None,
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,S,d], h_final [B,d,n]). The reference pads ``S`` to a
    multiple of ``chunk`` with steps that keep the state (decay 1, input
    0); here the last chunk is just shorter."""
    b, s, d = u.shape
    n = A.shape[1]
    h = h0 if h0 is not None else u.new_zeros((b, d, n))
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        dt_c = dt[:, sl]
        a = torch.exp(dt_c[..., None] * A)                       # [B,c,d,n]
        x_in = (dt_c * u[:, sl])[..., None] * Bc[:, sl, None, :]  # [B,c,d,n]
        a_s, b_s = _doubling_scan(a, x_in)
        hs = a_s * h[:, None] + b_s                              # [B,c,d,n]
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, Cc[:, sl]))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1) if ys else u.new_zeros((b, 0, d))
    return y, h


def mamba_forward(p, x: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """Full-sequence mamba mixer. x [B, S, D] -> [B, S, D]. The scan's
    final state is dropped, as in the reference."""
    d_inner = p["conv_w"].shape[1]
    ug = x @ p["in_proj"]
    u, z = ug[..., :d_inner], ug[..., d_inner:]
    u = F.silu(causal_conv1d(u, p["conv_w"], p["conv_b"]))
    u = constrain(u, ("batch", None, "act_ff"))  # shard d_inner over 'model'
    dt, Bc, Cc = _mamba_gates(p, u)
    A = -torch.exp(p["A_log"].float())
    scan = functools.partial(selective_scan_chunked, chunk=chunk)
    if is_distributed(u):
        scan = _channel_parallel(scan, u)
    y, _ = scan(u.float(), dt.float(), Bc.float(), Cc.float(), A)
    y = y.to(x.dtype) + u * p["D"]
    return (y * F.silu(z)) @ p["out_proj"]


def _channel_parallel(scan, u):
    """``scan(u, dt, Bc, Cc, A)`` (:func:`selective_scan_chunked`) on each
    rank's batch rows and channels, as ``u [B, S, d]`` is placed (``d``
    over ``model`` by the ``act_ff`` constraint): the channels scan
    independently, ``Bc`` / ``Cc`` are whole on every rank (their gradient
    partial over the channel axes) and ``A [d, n]`` is split with the
    channels. Returns ``(y, h)`` placed as ``u`` (``h [B, d, n]``: the
    channels on dim 1)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    upl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
                for p in u.placements)
    bpl = tuple(p if p == Shard(0) else Replicate() for p in upl)
    bgrad = tuple(Partial() if p == Shard(2) else q for p, q in zip(upl, bpl))
    apl = tuple(Shard(0) if p == Shard(2) else Replicate() for p in upl)
    hpl = tuple(Shard(1) if p == Shard(2) else p for p in upl)
    return local_map(scan, out_placements=(list(upl), list(hpl)),
                     in_placements=(upl, upl, bpl, bpl, apl),
                     in_grad_placements=(upl, upl, bgrad, bgrad, apl),
                     device_mesh=u.device_mesh, redistribute_inputs=True)


def mamba_state_shape(cfg_d_model: int, ssm_state: int, conv: int,
                      expand: int):
    d_inner = expand * cfg_d_model
    return {
        "ssm": (d_inner, ssm_state),
        "conv": (conv - 1, d_inner),
    }


def mamba_step(p, x_t: torch.Tensor, state: Dict[str, torch.Tensor]):
    """One decode step. x_t [B, D]; state {'ssm' [B,d,n], 'conv' [B,K-1,d]}.
    Returns (out [B, D], the new state); ``state`` is not written."""
    d_inner = p["conv_w"].shape[1]
    ug = x_t @ p["in_proj"]
    u, z = ug[..., :d_inner], ug[..., d_inner:]
    u, conv_state = conv1d_step(u, state["conv"], p["conv_w"], p["conv_b"])
    u = F.silu(u).to(x_t.dtype)
    dt, Bc, Cc = _mamba_gates(p, u)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt[..., None].float() * A)                   # [B,d,n]
    h = a * state["ssm"] + ((dt * u)[..., None] * Bc[:, None, :]).float()
    y = torch.einsum("bdn,bn->bd", h, Cc.float()).to(x_t.dtype) \
        + u * p["D"]
    out = (y * F.silu(z)) @ p["out_proj"]
    return out, {"ssm": h.to(state["ssm"].dtype),
                 "conv": conv_state.to(state["conv"].dtype)}


# ---------------------------------------------------------------------------
# mLSTM — matrix-memory LSTM (xLSTM), chunkwise-parallel + O(1) decode step
# ---------------------------------------------------------------------------


def mlstm_block_template(d_model: int, num_heads: int, conv: int,
                         expand: int) -> Dict:
    ud = expand * d_model
    return {
        "ln_w": ParamSpec((d_model,), (None,), init="zeros"),
        "up_proj": ParamSpec((d_model, 2 * ud), ("fsdp", "tensor")),
        "conv_w": ParamSpec((conv, ud), ("conv", "tensor")),
        "conv_b": ParamSpec((ud,), ("tensor",), init="zeros"),
        "wq": ParamSpec((ud, ud), ("fsdp", "tensor")),
        "wk": ParamSpec((ud, ud), ("fsdp", "tensor")),
        "wv": ParamSpec((ud, ud), ("fsdp", "tensor")),
        "w_gates": ParamSpec((d_model, 2 * num_heads), ("fsdp", None)),
        "b_gates": ParamSpec((2 * num_heads,), (None,), init="zeros"),
        "gn_w": ParamSpec((ud,), ("tensor",), init="ones"),
        "down_proj": ParamSpec((ud, d_model), ("tensor", "fsdp")),
    }


def mlstm_cell_step(qt, kt, vt, li, lf, state):
    """One decode step. qt/kt/vt [B,H,dh]; li/lf [B,H]; state (C,n,m)."""
    C, n, m = state
    dh = qt.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    qt, kt, vt = (x.float() for x in (qt, kt, vt))
    m_new = torch.maximum(lf + m, li)
    fg = torch.exp(lf + m - m_new)
    ig = torch.exp(li - m_new)
    C = (fg[..., None, None] * C
         + ig[..., None, None] * (kt[..., None] * vt[..., None, :]) * scale)
    n = fg[..., None] * n + ig[..., None] * kt * scale
    num = torch.einsum("bhd,bhde->bhe", qt, C)
    den = torch.einsum("bhd,bhd->bh", qt, n).abs()
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return h, (C, n, m_new)


def mlstm_cell_sequential(q, k, v, log_i, log_f, state=None):
    """Sequential oracle. q/k/v [B,S,H,dh]; log_i/log_f [B,S,H].

    Returns (h [B,S,H,dh], state (C [B,H,dh,dh], n [B,H,dh], m [B,H])).
    """
    b, s, h, dh = q.shape
    if state is None:
        state = (torch.zeros((b, h, dh, dh), device=q.device),
                 torch.zeros((b, h, dh), device=q.device),
                 torch.full((b, h), NEG_INF, device=q.device))
    hs = []
    for t in range(s):
        ht, state = mlstm_cell_step(q[:, t], k[:, t], v[:, t], log_i[:, t],
                                    log_f[:, t], state)
        hs.append(ht)
    out = torch.stack(hs, dim=1) if hs else q.float()
    return out.to(q.dtype), state


def mlstm_cell_chunked(q, k, v, log_i, log_f, chunk: int = 64):
    """Stabilised chunkwise-parallel mLSTM from the zero state, the
    reference's ``mlstm_cell_chunked`` (``repro/models/ssm.py:201-262``;
    its ``state=`` has no caller and is not carried): q/k/v [B, S, H, dh],
    log_i/log_f [B, S, H] (``log_f`` log-sigmoided). Returns (h [B, S, H,
    dh] in q's dtype, (C [B, H, dh, dh], n [B, H, dh], m [B, H])),
    computed in float32 (float64 for float64 inputs), ``S`` padded to a
    multiple of ``chunk`` as the reference pads it (zeros for q/k/v,
    ``log_i = NEG_INF``, ``log_f = 0``). Plain tensor operations, nothing
    written in place: training's mLSTM cell, differentiated by autograd,
    and in the kernel's layout the ``mlstm_scan`` kernel's plain version
    (``kernels/ref.mlstm_chunked_ref``)."""
    b, s, h, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    nchunks = -(-s // chunk)
    pad = nchunks * chunk - s
    dt = torch.promote_types(q.dtype, torch.float32)
    # head-major from here on: [B, H, S, dh], the gates [B, H, S]
    qh, kh, vh, log_i, log_f = (x.transpose(1, 2).to(dt)
                                for x in (q, k, v, log_i, log_f))
    if pad:
        qh, kh, vh = (F.pad(x, (0, 0, 0, pad)) for x in (qh, kh, vh))
        log_i = F.pad(log_i, (0, pad), value=NEG_INF)
        log_f = F.pad(log_f, (0, pad))
    dev = q.device
    C = torch.zeros((b, h, dh, dh), dtype=dt, device=dev)
    n = torch.zeros((b, h, dh), dtype=dt, device=dev)
    m = torch.full((b, h), NEG_INF, dtype=dt, device=dev)
    tmask = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    hs = []
    for j in range(nchunks):
        sl = slice(j * chunk, (j + 1) * chunk)
        qc, kc, vc = qh[:, :, sl], kh[:, :, sl], vh[:, :, sl]  # [B,H,c,dh]
        li, lf = log_i[:, :, sl], log_f[:, :, sl]              # [B,H,c]
        A = torch.cumsum(lf, dim=-1)                           # inclusive
        # intra-chunk log weights W[t, s] = A_t - A_s + li_s (s <= t)
        W = A[..., :, None] - A[..., None, :] + li[..., None, :]
        W = torch.where(tmask, W, torch.full_like(W, NEG_INF))
        binter = A + m[..., None]                              # carried state
        m_loc = torch.maximum(W.amax(dim=-1), binter)
        P = torch.exp(W - m_loc[..., None]) * (qc @ kc.transpose(-1, -2)
                                               * scale)
        e_inter = torch.exp(binter - m_loc)
        num = P @ vc + e_inter[..., None] * (qc @ C)
        den = P.sum(dim=-1) + e_inter * (qc @ n[..., None])[..., 0]
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_loc))[..., None])
        # ---- state update to the end of the chunk ----
        A_T = A[..., -1]
        w_end = A_T[..., None] - A + li
        m_new = torch.maximum(A_T + m, w_end.amax(dim=-1))
        kw = kc * scale * torch.exp(w_end - m_new[..., None])[..., None]
        decay = torch.exp(A_T + m - m_new)
        C = decay[..., None, None] * C + kw.transpose(-1, -2) @ vc
        n = decay[..., None] * n + kw.sum(dim=-2)
        m = m_new
    out = (torch.cat(hs, dim=2) if hs else qh)[:, :, :s]
    return out.transpose(1, 2).to(q.dtype), (C, n, m)


def _mlstm_proj(p, h, u, cu, num_heads: int):
    """q, k from the conv branch ``cu`` and v from ``u``, split into heads:
    [..., ud] -> [..., H, dh]."""
    ud = u.shape[-1]
    q = (cu @ p["wq"]).unflatten(-1, (num_heads, ud // num_heads))
    k = (cu @ p["wk"]).unflatten(-1, (num_heads, ud // num_heads))
    v = (u @ p["wv"]).unflatten(-1, (num_heads, ud // num_heads))
    gates = (h @ p["w_gates"] + p["b_gates"]).float()
    return q, k, v, gates[..., :num_heads], F.logsigmoid(gates[..., num_heads:])


def _mlstm_block(p, x, cfg, cell):
    """The mLSTM residual block around ``cell(q, k, v, log_i, log_f) ->
    (h [B, S, H, dh], state)``, all in the ``[B, S, H, ...]`` layout:
    ``(x + out, state)``."""
    h = rms_norm(x, p["ln_w"], 1e-5)
    ud = p["conv_w"].shape[1]
    H = cfg.num_heads
    upg = h @ p["up_proj"]
    u, z = upg[..., :ud], upg[..., ud:]
    cu = F.silu(causal_conv1d(u, p["conv_w"], p["conv_b"]))
    b, s, _ = x.shape
    hout, st = cell(*_mlstm_proj(p, h, u, cu, H))
    hout = group_norm(hout.reshape(b, s, ud), p["gn_w"], H)
    out = (hout * F.silu(z)) @ p["down_proj"]
    return x + out, st


def mlstm_block_forward(p, x, cfg, *, chunk: int = 64, return_state=False,
                        impl: str = "auto"):
    """Full mLSTM residual block of the serving path. x [B,S,D]. ``impl``
    is the ``ops.mlstm_scan`` impl of the scan."""
    def scan(q, k, v, log_i, log_f):
        # the kernel's layout [B, H, S, dh]; the gates [B, H, S]
        hout, st = ops.mlstm_scan(
            *(t.transpose(1, 2).contiguous()
              for t in (q, k, v, log_i, log_f)),
            chunk=chunk, impl=impl, return_state=True)
        return hout.transpose(1, 2), st

    y, st = _mlstm_block(p, x, cfg, scan)
    return (y, st) if return_state else y


def mlstm_block_train(p, x, cfg, *, chunk: int = 64):
    """Full mLSTM residual block in its training form, x [B,S,D]: the
    scan is :func:`mlstm_cell_chunked`, as the reference's
    ``mlstm_block_forward`` calls it (``repro/models/ssm.py:295``)."""
    def cell(q, k, v, log_i, log_f):
        return mlstm_cell_chunked(q, k, v, log_i, log_f, chunk=chunk)

    return _mlstm_block(p, x, cfg, cell)[0]


def mlstm_block_step(p, x_t, cfg, state):
    """Decode step. x_t [B,D]; state {'C','n','m','conv'}."""
    h = rms_norm(x_t, p["ln_w"], 1e-5)
    ud = p["conv_w"].shape[1]
    H = cfg.num_heads
    upg = h @ p["up_proj"]
    u, z = upg[..., :ud], upg[..., ud:]
    cu, conv_state = conv1d_step(u, state["conv"], p["conv_w"], p["conv_b"])
    cu = F.silu(cu)
    b = x_t.shape[0]
    q, k, v, log_i, log_f = _mlstm_proj(p, h, u, cu, H)
    hc, (C, n, m) = mlstm_cell_step(q, k, v, log_i, log_f,
                                    (state["C"], state["n"], state["m"]))
    hc = group_norm(hc.reshape(b, ud), p["gn_w"], H)
    out = (hc.to(x_t.dtype) * F.silu(z)) @ p["down_proj"]
    return x_t + out, {"C": C, "n": n, "m": m, "conv": conv_state}


# ---------------------------------------------------------------------------
# sLSTM — scalar-memory LSTM with recurrent weights (inherently sequential)
# ---------------------------------------------------------------------------

def slstm_block_template(d_model: int, num_heads: int) -> Dict:
    dh = d_model // num_heads
    pf = -(-4 * d_model // 3)  # post-FFN projection factor 4/3
    return {
        "ln_w": ParamSpec((d_model,), (None,), init="zeros"),
        "w_in": ParamSpec((d_model, 4 * d_model), ("fsdp", "tensor")),
        "b_in": ParamSpec((4 * d_model,), ("tensor",), init="zeros"),
        "r_rec": ParamSpec((4, num_heads, dh, dh),
                           (None, "heads", None, None), scale=0.5),
        "gn_w": ParamSpec((d_model,), ("tensor",), init="ones"),
        "ffn_ln_w": ParamSpec((d_model,), (None,), init="zeros"),
        "ffn_up": ParamSpec((d_model, 2 * pf), ("fsdp", "tensor")),
        "ffn_down": ParamSpec((pf, d_model), ("tensor", "fsdp")),
    }


def _slstm_scan(p, hx, num_heads: int, state):
    """hx [B,S,4*D] precomputed input projections; sequential over S."""
    b, s, d4 = hx.shape
    d = d4 // 4
    dh = d // num_heads
    c, n, m, h = state
    c, n, m = (t.float() for t in (c, n, m))
    h = h.to(hx.dtype)
    hs = []
    for t in range(s):
        zi = hx[:, t].reshape(b, 4, num_heads, dh)
        rec = torch.einsum("bhd,khde->kbhe", h, p["r_rec"])
        z_t = torch.tanh(zi[:, 0] + rec[0])
        li = (zi[:, 1] + rec[1]).float()
        lf = F.logsigmoid((zi[:, 2] + rec[2]).float())
        o = torch.sigmoid(zi[:, 3] + rec[3])
        m_new = torch.maximum(lf + m, li)
        fg = torch.exp(lf + m - m_new)
        ig = torch.exp(li - m_new)
        c = fg * c + ig * z_t.float()
        n = fg * n + ig
        m = m_new
        h = (o.float() * (c / torch.clamp(n, min=1e-6))).to(hx.dtype)
        hs.append(h)
    out = torch.stack(hs, dim=1).reshape(b, s, d) if hs else hx[..., :d]
    return out, (c, n, m, h)


def slstm_init_state(b: int, num_heads: int, d_model: int, *, device=None):
    dh = d_model // num_heads
    z = torch.zeros((b, num_heads, dh), dtype=torch.float32, device=device)
    return (z, z, torch.full((b, num_heads, dh), NEG_INF, device=device),
            torch.zeros((b, num_heads, dh), device=device))


def slstm_block_forward(p, x, cfg, *, state=None, return_state=False):
    b, s, d = x.shape
    H = cfg.num_heads
    h = rms_norm(x, p["ln_w"], 1e-5)
    hx = h @ p["w_in"] + p["b_in"]
    if state is None:
        state = slstm_init_state(b, H, d, device=x.device)
    hs, st = _slstm_scan(p, hx, H, state)
    hs = group_norm(hs, p["gn_w"], H)
    y = x + hs
    # gated FFN (4/3 projection factor)
    f = rms_norm(y, p["ffn_ln_w"], 1e-5)
    pf = p["ffn_down"].shape[0]
    up = f @ p["ffn_up"]
    f = gelu(up[..., :pf]) * up[..., pf:]
    out = y + f @ p["ffn_down"]
    if return_state:
        return out, st
    return out


def slstm_block_step(p, x_t, cfg, state):
    out, st = slstm_block_forward(
        p, x_t[:, None, :], cfg,
        state=(state["c"], state["n"], state["m"], state["h"]),
        return_state=True)
    return out[:, 0, :], {"c": st[0], "n": st[1], "m": st[2], "h": st[3]}
