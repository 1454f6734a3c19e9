from .api import Module
from .gpt import PRESETS, GPTConfig, GPTModel, build

__all__ = ["GPTConfig", "GPTModel", "Module", "PRESETS", "build"]
