"""Inference configuration (counterpart of ``deepspeed_tpu/inference/config.py``).

A plain dataclass, built with :meth:`DeepSpeedInferenceConfig.from_dict` from
the same JSON keys and aliases as the reference (``tp`` for
``tensor_parallel``, ``max_tokens`` for ``max_out_tokens``). Unknown keys are
ignored, as the reference's ``extra="ignore"`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

_DTYPE_NAMES = {"half": "float16", "fp16": "float16", "float": "float32",
                "fp32": "float32", "bf16": "bfloat16", "torch.half": "float16",
                "torch.float16": "float16", "torch.bfloat16": "bfloat16",
                "torch.float32": "float32"}
_TORCH_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
                 "float32": torch.float32}


def _from_dict(cls, d: Dict[str, Any], aliases: Dict[str, str]):
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in d.items():
        key = aliases.get(key, key)
        if key in names:
            kwargs[key] = value
    return cls(**kwargs)


@dataclasses.dataclass
class DeepSpeedTPConfig:
    enabled: bool = True
    tp_size: int = 1


@dataclasses.dataclass
class DeepSpeedMoEConfig:
    enabled: bool = True
    ep_size: int = 1
    moe_experts: list = dataclasses.field(default_factory=lambda: [1])


@dataclasses.dataclass
class QuantizationConfig:
    enabled: bool = False
    qkv: bool = True
    bits: int = 8
    group_size: int = 128


@dataclasses.dataclass
class DeepSpeedInferenceConfig:
    dtype: str = "bfloat16"  # torch-style names also accepted ("half", "float16", ...)
    tensor_parallel: DeepSpeedTPConfig = dataclasses.field(default_factory=DeepSpeedTPConfig)
    moe: DeepSpeedMoEConfig = dataclasses.field(default_factory=DeepSpeedMoEConfig)
    quant: QuantizationConfig = dataclasses.field(default_factory=QuantizationConfig)
    max_out_tokens: int = 1024
    min_out_tokens: int = 1
    # 0 = unbounded; a positive value is enforced at generate()
    max_batch_size: int = 0
    # when set, generate rounds max_new_tokens UP to the nearest bucket and
    # slices the output back (serving/buckets.py)
    decode_buckets: Optional[list] = None
    # accepted; generate runs eagerly until its CUDA-graph capture is ported
    # (ROADMAP.md A5b)
    enable_cuda_graph: bool = True
    # an on-disk checkpoint to load: not ported (init_inference raises)
    checkpoint: Optional[Any] = None

    _ALIASES = {"tp": "tensor_parallel", "max_tokens": "max_out_tokens"}

    def __post_init__(self):
        for name, cls in (("tensor_parallel", DeepSpeedTPConfig),
                          ("moe", DeepSpeedMoEConfig), ("quant", QuantizationConfig)):
            value = getattr(self, name)
            if isinstance(value, dict):
                setattr(self, name, _from_dict(cls, value, {}))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeepSpeedInferenceConfig":
        return _from_dict(cls, d, cls._ALIASES)

    def torch_dtype(self) -> torch.dtype:
        name = str(self.dtype).lower()
        name = _DTYPE_NAMES.get(name, name)
        if name == "int8":
            raise NotImplementedError(
                "dtype int8 (quantized inference) is not ported to "
                "deepspeed_tpu_torch yet (ROADMAP.md A8)")
        if name not in _TORCH_DTYPES:
            raise ValueError(f"unknown inference dtype {self.dtype!r}")
        return _TORCH_DTYPES[name]
