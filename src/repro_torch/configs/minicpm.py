# libra: waive[IMPORT001] loaded by name via repro_torch.configs (importlib), which the static graph cannot see
"""minicpm-2b [dense] — arXiv:2404.06395 / hf (llama-like, WSD schedule).

40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753.
MiniCPM uses mu-p style depth scaling of residual branches and a
warmup-stable-decay (WSD) LR schedule; both are first-class here
(``residual_scale`` in serving; ``lr_schedule='wsd'`` is read by training,
which the port does not have yet).
"""
import math

from repro_torch.common.types import ModelConfig

_L = 40

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=_L,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    act="swiglu",
    tie_embeddings=True,
    # MiniCPM: residual branches scaled by 1.4/sqrt(num_layers)
    residual_scale=1.4 / math.sqrt(_L),
    # logits scaled by 1/(d_model/256) via embed_scale on the output head
    embed_scale=1.0 / (2304 / 256),
    lr_schedule="wsd",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="minicpm-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=160,
        vocab_size=256,
        act="swiglu",
        tie_embeddings=True,
        residual_scale=1.4 / math.sqrt(2),
        embed_scale=0.25,
        lr_schedule="wsd",
    )
