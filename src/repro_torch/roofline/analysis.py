"""Roofline terms: compute / memory / collective seconds per step per
device, plus analytic MODEL_FLOPS for the useful-compute ratio.

PyTorch twin of the JAX package's ``repro.roofline.analysis``; the model
FLOPs are pure Python on the config, copied. The terms divide by the
H100 row of ``hw``: ring bytes over one NVLink direction, as the reference
divides them by one link of its interconnect. A 16-wide ``model`` axis
spans two 8-GPU nodes, so part of its ring crosses InfiniBand
(``hw.IB_BW``, 9x slower): there the collective term is a lower bound.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.common.types import ModelConfig, ShapeSpec
from repro_torch.roofline import hw
from repro_torch.roofline.op_analysis import OpCosts


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_total: float        # analytic useful FLOPs (whole step, all devices)
    hlo_flops_device: float         # counted FLOPs per device (the reference's key)
    useful_ratio: float             # model_flops / (counted flops * devices)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def roofline_terms(costs: OpCosts, model_flops: float, n_chips: int,
                   compute_dtype_peak: float = hw.PEAK_FLOPS_BF16
                   ) -> RooflineTerms:
    compute_s = costs.flops / compute_dtype_peak
    memory_s = costs.hbm_bytes / hw.HBM_BW
    collective_s = costs.collective_ring / hw.NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    total = costs.flops * n_chips
    return RooflineTerms(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops_total=model_flops,
        hlo_flops_device=float(costs.flops),
        useful_ratio=(model_flops / total) if total else 0.0)


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS (6·N·D convention + attention/scan terms)
# ---------------------------------------------------------------------------

def _embed_params(cfg: ModelConfig) -> int:
    return cfg.vocab_size * cfg.d_model


def matmul_params(cfg: ModelConfig) -> int:
    """Active parameters that participate in matmuls (embedding lookup
    excluded; tied lm_head counted once as compute below)."""
    n = cfg.active_param_count()
    n -= _embed_params(cfg)  # lookup table
    return max(n, 0)


def _attn_flops_fwd(cfg: ModelConfig, tokens: int, ctx: int, batch: int) -> float:
    """Score + PV flops for causal attention, per forward pass."""
    if cfg.family == "ssm":
        # recurrent scan term: ~10 flops per (token, channel, state)
        ud = cfg.ssm_expand * cfg.d_model
        return 10.0 * tokens * ud * (ud // cfg.num_heads) / 64  # matrix memory, chunked
    qdim = cfg.num_heads * cfg.head_dim
    layers = cfg.num_layers
    if cfg.family == "hybrid":
        # window layers see min(ctx, window); plus mamba scan term
        n_glob = len(cfg.global_attn_layers)
        n_win = layers - n_glob
        eff = n_glob * ctx / 2 + n_win * min(cfg.window, ctx / 2)
        ssm = 10.0 * tokens * (cfg.ssm_expand * cfg.d_model) * cfg.ssm_state * layers
        return 4.0 * tokens * qdim * eff + ssm
    if cfg.family == "encdec":
        enc = 4.0 * batch * cfg.enc_frames * cfg.enc_frames * qdim * cfg.enc_layers / 1
        self_a = 4.0 * tokens * qdim * (ctx / 2) * layers
        cross = 4.0 * tokens * qdim * cfg.enc_frames * layers
        return enc + self_a + cross
    return 4.0 * tokens * qdim * (ctx / 2) * layers


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    b, s = shape.global_batch, shape.seq_len
    nm = matmul_params(cfg)
    logits_flops = 2.0 * cfg.d_model * cfg.vocab_size

    if shape.kind == "train":
        tokens = b * s
        fwd = 2.0 * tokens * nm + tokens * logits_flops \
            + _attn_flops_fwd(cfg, tokens, s, b)
        return 3.0 * fwd
    if shape.kind == "prefill":
        tokens = b * s
        return 2.0 * tokens * nm + b * logits_flops \
            + _attn_flops_fwd(cfg, tokens, s, b)
    # decode: one token per request over ctx = s
    tokens = b
    if cfg.family == "ssm":
        scan = _attn_flops_fwd(cfg, tokens, s, b)
        return 2.0 * tokens * nm + tokens * logits_flops + scan
    qdim = cfg.num_heads * cfg.head_dim
    if cfg.family == "hybrid":
        n_glob = len(cfg.global_attn_layers)
        n_win = cfg.num_layers - n_glob
        eff = n_glob * s + n_win * min(cfg.window, s)
        attn = 4.0 * tokens * qdim * eff
        attn += 10.0 * tokens * (cfg.ssm_expand * cfg.d_model) * cfg.ssm_state \
            * cfg.num_layers
    elif cfg.family == "encdec":
        attn = 4.0 * tokens * qdim * s * cfg.num_layers \
            + 4.0 * tokens * qdim * cfg.enc_frames * cfg.num_layers
    else:
        attn = 4.0 * tokens * qdim * s * cfg.num_layers
    if cfg.family == "encdec":
        # decoder-side matmul params only for the per-step cost
        nm = nm // 2
    return 2.0 * tokens * nm + tokens * logits_flops + attn
