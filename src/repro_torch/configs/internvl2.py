# libra: waive[IMPORT001] loaded by name via repro_torch.configs (importlib), which the static graph cannot see
"""internvl2-76b [vlm] — arXiv:2404.16821 (InternViT-6B + LLaMA-3-70B-style LM).

Backbone: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The InternViT frontend is a STUB per the assignment: ``input_specs()``
provides precomputed, already-projected patch embeddings
[B, img_tokens, d_model]; the backbone consumes them as prefix payload
(the Libra anchored-payload analogue) followed by text tokens (metadata).
"""
from repro_torch.common.types import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    img_tokens=256,
    rope_theta=500000.0,
    act="swiglu",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internvl2-reduced",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        img_tokens=8,
        act="swiglu",
    )
