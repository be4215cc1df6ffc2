# libra: waive[IMPORT001] loaded by name via repro_torch.configs (importlib), which the static graph cannot see
"""phi4-mini-3.8b [dense] — arXiv:2412.08905 / hf.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064, RoPE + SwiGLU.
"""
from repro_torch.common.types import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    rope_theta=10000.0,
    act="swiglu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        act="swiglu",
        tie_embeddings=True,
    )
