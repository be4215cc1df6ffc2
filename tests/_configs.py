"""The port's ``ModelConfig`` against the JAX package's: every field of the
reference's equal, and each field the port adds (``qkv_bias``,
``norm_topk``) at the default that keeps the reference's behaviour."""
import dataclasses

from repro_torch.common.types import PORT_ONLY_DEFAULTS


def assert_config_matches_jax(jax_cfg, port_cfg) -> None:
    j, t = dataclasses.asdict(jax_cfg), dataclasses.asdict(port_cfg)
    assert {k: t[k] for k in j} == j
    assert {k: v for k, v in t.items() if k not in j} == PORT_ONLY_DEFAULTS
