from .cpu_adam import DeepSpeedCPUAdagrad, DeepSpeedCPUAdam

__all__ = ["DeepSpeedCPUAdam", "DeepSpeedCPUAdagrad"]
