from .gpt import PRESETS, GPTConfig, GPTModel

__all__ = ["GPTConfig", "GPTModel", "PRESETS"]
