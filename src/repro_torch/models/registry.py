"""Model registry of the port: config -> model instance.

Only the dense family is ported (``TransformerLM``); the other families
raise ``NotImplementedError`` from the model's constructor.
"""
from __future__ import annotations

from repro_torch.common.types import ModelConfig

PAGE_SIZE = 64  # tokens per anchored KV page (A.5 granularity matching)


def build_model(cfg: ModelConfig, page_size: int = PAGE_SIZE,
                attn_impl: str = "auto"):
    from repro_torch.models.transformer import TransformerLM

    return TransformerLM(cfg, page_size, attn_impl=attn_impl)


def count_params_from_config(cfg: ModelConfig) -> int:
    return build_model(cfg).param_count()
