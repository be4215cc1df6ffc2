"""Model registry of the port: config -> model instance.

The dense, ``moe``, ``hybrid`` and ``vlm`` families build a
``TransformerLM``, the ``ssm`` family (xLSTM) an ``XLSTMModel`` and the
``encdec`` family (whisper) an ``EncDecModel``.
"""
from __future__ import annotations

from repro_torch.common.types import ModelConfig

PAGE_SIZE = 64  # tokens per anchored KV page (A.5 granularity matching)


def build_model(cfg: ModelConfig, page_size: int = PAGE_SIZE,
                attn_impl: str = "auto", mlstm_impl: str = "auto"):
    """``page_size`` and ``attn_impl`` (the attention kernels' ``ops``
    impl) apply to the ``TransformerLM`` and ``EncDecModel`` families,
    ``mlstm_impl`` (the mLSTM scan's) to the ``ssm`` family."""
    if cfg.family == "ssm":
        from repro_torch.models.xlstm_model import XLSTMModel

        return XLSTMModel(cfg, mlstm_impl=mlstm_impl)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecModel

        return EncDecModel(cfg, page_size, attn_impl=attn_impl)
    from repro_torch.models.transformer import TransformerLM

    return TransformerLM(cfg, page_size, attn_impl=attn_impl)


def count_params_from_config(cfg: ModelConfig,
                             active_only: bool = False) -> int:
    """Parameters of ``cfg``'s model; with ``active_only``, a ``moe``
    config counts only the ``top_k`` routed experts a token reaches (the
    padded experts are inactive too), as the JAX package counts."""
    total = build_model(cfg).param_count()
    if active_only and cfg.family == "moe":
        per_expert = 3 * cfg.d_model * cfg.expert_d_ff
        total -= (cfg.padded_experts - cfg.top_k) * per_expert * cfg.num_layers
    return total
