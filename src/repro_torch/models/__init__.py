from .common import ModelConfig

__all__ = ["ModelConfig"]
