# libra: waive[IMPORT001] loaded by name via repro_torch.configs (importlib), which the static graph cannot see
"""libra-proxy-125m — the paper-scenario model.

A small dense LM standing in for the L7-proxy workload driver: the serving
examples/benchmarks run this model under the Libra engine (selective copy +
anchored KV + VPI forwarding) vs the Standard/Copier/Static engines, which
reproduces the paper's Nginx/HAProxy comparison shape at laptop scale.
"""
from repro_torch.common.types import ModelConfig

CONFIG = ModelConfig(
    name="libra-proxy-125m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=32000,
    act="swiglu",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="libra-proxy-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        act="swiglu",
    )
