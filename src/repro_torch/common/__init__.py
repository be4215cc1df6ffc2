from repro_torch.common.types import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    MULTI_POD,
    PREFILL_32K,
    SHAPES_BY_NAME,
    SINGLE_POD,
    TRAIN_4K,
    MeshSpec,
    ModelConfig,
    RunShape,
    ShapeSpec,
)

__all__ = [
    "ModelConfig",
    "ShapeSpec",
    "MeshSpec",
    "RunShape",
    "ALL_SHAPES",
    "SHAPES_BY_NAME",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "SINGLE_POD",
    "MULTI_POD",
]
