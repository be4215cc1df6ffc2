# libra: waive[IMPORT001] loaded by name via repro_torch.configs (importlib), which the static graph cannot see
"""qwen2-moe-a2.7b [moe] — hf:Qwen/Qwen1.5-MoE-A2.7B.

24L d_model=2048 16H (kv=16) per-expert d_ff=1408 vocab=151936,
60 routed experts top-4 + 4 shared experts (shared FFN d_ff = 4*1408).
Experts padded 60 -> 64 so EP-16 divides; the padded experts are never
routed to (``models/moe.py``, ``router_topk``).
"""
from repro_torch.common.types import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,
    expert_d_ff=1408,
    num_experts=60,
    expert_pad_to=64,
    num_shared_experts=4,
    top_k=4,
    vocab_size=151936,
    act="swiglu",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-reduced",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        expert_d_ff=32,
        num_experts=6,
        expert_pad_to=8,
        num_shared_experts=2,
        top_k=2,
        vocab_size=256,
        act="swiglu",
    )
