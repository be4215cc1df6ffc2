# libra: waive[IMPORT001] loaded by name via repro_torch.configs (importlib), which the static graph cannot see
"""qwen3-moe-30b-a3b [moe] — hf:Qwen/Qwen3-30B-A3B.

48L d_model=2048 32H (GQA kv=4) per-expert d_ff=768 vocab=151936,
128 experts top-8, QK-norm, no shared experts.
"""
from repro_torch.common.types import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,
    expert_d_ff=768,
    num_experts=128,
    top_k=8,
    vocab_size=151936,
    rope_theta=1000000.0,
    act="swiglu",
    qk_norm=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-reduced",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=0,
        expert_d_ff=32,
        num_experts=8,
        top_k=2,
        vocab_size=256,
        act="swiglu",
        qk_norm=True,
    )
