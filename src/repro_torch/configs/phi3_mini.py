# libra: waive[IMPORT001] loaded by name via repro_torch.configs (importlib), which the static graph cannot see
"""phi3-mini-3.8b [dense] — arXiv:2404.14219.

32L d_model=3072 32H (GQA kv=32, i.e. MHA) d_ff=8192 vocab=32064,
RoPE + SwiGLU.
"""
from repro_torch.common.types import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10000.0,
    act="swiglu",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        act="swiglu",
    )
