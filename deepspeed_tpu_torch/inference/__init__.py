from .config import DeepSpeedInferenceConfig
from .engine import InferenceEngine, for_gpt

__all__ = ["InferenceEngine", "DeepSpeedInferenceConfig", "for_gpt"]
