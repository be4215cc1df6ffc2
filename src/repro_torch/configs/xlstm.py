# libra: waive[IMPORT001] loaded by name via repro_torch.configs (importlib), which the static graph cannot see
"""xlstm-350m [ssm] — arXiv:2405.04517.

24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304 — sLSTM + mLSTM blocks.
d_ff=0: blocks carry their own up/down projections (mLSTM pre-up x2,
sLSTM post-FFN 4/3 gated), per the paper. We use the xLSTM[7:1] layout:
one sLSTM block every 8 blocks, the rest mLSTM.
"""
from repro_torch.common.types import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,
    ssm_conv=4,
    ssm_expand=2,
    act="gelu",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="xlstm-reduced",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=2,
        num_kv_heads=2,
        d_ff=0,
        vocab_size=256,
        slstm_every=2,
        ssm_conv=4,
        ssm_expand=2,
        act="gelu",
    )
