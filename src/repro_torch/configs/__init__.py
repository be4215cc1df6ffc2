"""Architecture config registry of the port.

The same modules as the JAX package's ``repro.configs``, copied: each exports
``CONFIG`` (the published configuration) and ``reduced()`` (a small
same-family config for CPU tests). Here are the dense configs that
``LibraEngine`` serves and the ``ssm`` config xlstm-350m, which
``XLSTMModel`` runs; the other architectures wait for their model families
(``ROADMAP.md``, queue 1, items 5 and 7).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.common.types import ModelConfig

_ARCH_MODULES = {
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini",
    "xlstm-350m": "repro_torch.configs.xlstm",
    # the paper's own scenario: a tiny router/proxy LM used by the serving
    # examples and benchmarks (not part of the 10-arch assignment)
    "libra-proxy-125m": "repro_torch.configs.libra_proxy",
}

#: architectures of the JAX package whose model family is not ported yet
NOT_PORTED = ("minicpm-2b", "mistral-nemo-12b", "hymba-1.5b", "whisper-medium",
              "qwen3-moe-30b-a3b", "qwen2-moe-a2.7b", "internvl2-76b")

ARCHS: List[str] = [k for k in _ARCH_MODULES if k != "libra-proxy-125m"]


def _module(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name!r} is not ported yet (ROADMAP.md, queue 1, items 5 and 7)")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}
