"""Architecture config registry of the port.

The same modules as the JAX package's ``repro.configs``, copied, in the
same order: each exports ``CONFIG`` (the published configuration) and
``reduced()`` (a small same-family config for CPU tests).
``get_config(name)`` / ``get_reduced(name)`` look them up.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.common.types import ModelConfig

_ARCH_MODULES = {
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini",
    "minicpm-2b": "repro_torch.configs.minicpm",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo",
    "hymba-1.5b": "repro_torch.configs.hymba",
    "xlstm-350m": "repro_torch.configs.xlstm",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe",
    "internvl2-76b": "repro_torch.configs.internvl2",
    # the paper's own scenario: a tiny router/proxy LM used by the serving
    # examples and benchmarks (not part of the 10-arch assignment)
    "libra-proxy-125m": "repro_torch.configs.libra_proxy",
}

ARCHS: List[str] = [k for k in _ARCH_MODULES if k != "libra-proxy-125m"]


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}
