"""Model registry of the port: config -> model instance.

The dense, ``moe`` and ``hybrid`` families build a ``TransformerLM`` and
the ``ssm`` family (xLSTM) an ``XLSTMModel``; the other families (``vlm``,
``encdec``) raise ``NotImplementedError`` from ``TransformerLM``'s
constructor.
"""
from __future__ import annotations

from repro_torch.common.types import ModelConfig

PAGE_SIZE = 64  # tokens per anchored KV page (A.5 granularity matching)


def build_model(cfg: ModelConfig, page_size: int = PAGE_SIZE,
                attn_impl: str = "auto", mlstm_impl: str = "auto"):
    """``page_size`` and ``attn_impl`` (the attention kernels' ``ops``
    impl) apply to the ``TransformerLM`` families, ``mlstm_impl`` (the
    mLSTM scan's) to the ``ssm`` family."""
    if cfg.family == "ssm":
        from repro_torch.models.xlstm_model import XLSTMModel

        return XLSTMModel(cfg, mlstm_impl=mlstm_impl)
    from repro_torch.models.transformer import TransformerLM

    return TransformerLM(cfg, page_size, attn_impl=attn_impl)


def count_params_from_config(cfg: ModelConfig) -> int:
    return build_model(cfg).param_count()
