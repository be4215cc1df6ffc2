from repro_torch.common.types import ModelConfig

__all__ = ["ModelConfig"]
