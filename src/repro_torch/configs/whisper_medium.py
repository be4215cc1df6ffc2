# libra: waive[IMPORT001] loaded by name via repro_torch.configs (importlib), which the static graph cannot see
"""whisper-medium [audio] — arXiv:2212.04356.

24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865 — encoder-decoder.
The conv frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings [B, enc_frames, d_model] (whisper: 1500 frames
for 30 s audio). The backbone is 24 encoder + 24 decoder layers with GELU
FFNs and cross-attention; sinusoidal positions so synthetic long-decoder
shapes remain well-defined.
"""
from repro_torch.common.types import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,       # decoder layers
    enc_layers=24,       # encoder layers
    enc_frames=1500,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    act="gelu",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-reduced",
        family="encdec",
        num_layers=2,
        enc_layers=2,
        enc_frames=16,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        act="gelu",
        tie_embeddings=True,
    )
