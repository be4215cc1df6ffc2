"""Helpers of the benchmark's tests: a cell at a tiny size on the CPU.

``tiny_config`` keeps a configuration's file and puts the port's
``reduced()`` model of that architecture in it (its layout taken from the
model's template); ``tiny_mix`` is a short closed loop over a frozen list
written by the mixes' own generator.
"""
from __future__ import annotations

import copy
from typing import Dict

from perfbench import harness, traffic

MODEL_KEYS = ("name", "family", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "head_dim", "d_ff", "expert_d_ff", "num_experts",
              "expert_pad_to", "num_shared_experts", "top_k", "vocab_size",
              "rope_theta", "norm_eps", "tie_embeddings", "act")


def layout_of(template) -> Dict:
    if isinstance(template, dict):
        return {k: layout_of(v) for k, v in template.items()}
    return list(template.shape)


def tiny_config(name: str) -> Dict:
    from repro_torch.configs import get_reduced
    from repro_torch.models.registry import build_model

    config = copy.deepcopy(harness.load_json("configs", name))
    cfg = get_reduced(name)
    config["model"] = {k: getattr(cfg, k) for k in MODEL_KEYS
                       if k in config["model"]}
    config["params"] = layout_of(build_model(cfg, 16).template())
    config["check"] = {"served_logit_gap_max": 1e-4}
    return config


def tiny_mix(clients: int = 4, count: int = 1024, warm: str = "first_completion",
             check_from: str = "served") -> Dict:
    gen = {"seed": 7, "count": count,
           "prompt": {"dist": "uniform", "min": 8, "max": 40},
           "output": {"dist": "uniform", "min": 4, "max": 12}}
    return {"name": "tiny", "loop": "closed", "clients": clients,
            "slots": clients, "setup_group": 2, "warm": warm,
            "warm_steps": 1, "check": {"from": check_from, "requests": 4},
            "generator": gen, "requests": traffic.generate(gen)}


def serve_cpu(config: Dict, mix: Dict, seed: int, seconds: float = 1.0) -> Dict:
    return harness.serve(config, mix, seed, seconds, trace=False,
                         device="cpu", metrics=[], clock=lambda: 0.0)
