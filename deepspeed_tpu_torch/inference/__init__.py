from .config import DeepSpeedInferenceConfig
from .engine import InferenceEngine, filter_logits, for_gpt

__all__ = ["InferenceEngine", "DeepSpeedInferenceConfig", "filter_logits", "for_gpt"]
