# libra: waive[IMPORT001] loaded by name via repro_torch.configs (importlib), which the static graph cannot see
"""hymba-1.5b [hybrid] — arXiv:2411.13676 / hf.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Parallel attention + mamba heads within each block; sliding-window
attention everywhere except three global-attention layers (first,
middle, last).
"""
from repro_torch.common.types import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    window=1024,
    global_attn_layers=(0, 15, 31),
    act="swiglu",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="hymba-reduced",
        family="hybrid",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        ssm_state=8,
        ssm_conv=4,
        ssm_expand=2,
        window=16,
        global_attn_layers=(0,),
        act="swiglu",
    )
