# libra: waive[IMPORT001] loaded by name via repro_torch.configs (importlib), which the static graph cannot see
"""mistral-nemo-12b [dense] — hf:mistralai/Mistral-Nemo-Base-2407.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, 128k context.
Nemo uses an explicit head_dim=128 (q_dim 4096 != d_model 5120).
"""
from repro_torch.common.types import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1000000.0,
    act="swiglu",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-reduced",
        family="dense",
        num_layers=2,
        d_model=96,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=256,
        rope_theta=1000000.0,
        act="swiglu",
    )
