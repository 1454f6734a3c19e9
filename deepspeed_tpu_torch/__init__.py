"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu``.

It runs on an NVIDIA H100; the kernels the JAX package wrote in Pallas for
the TPU are written here by hand in CUDA C++ for Hopper (``csrc/``), built by
``nvcc`` at first use. Every entry point runs on the CUDA device unless the
caller passes ``device="cpu"``, which takes the plain PyTorch versions of
the kernels. The package imports torch and numpy, never jax and nothing of
``deepspeed_tpu``.

Ported so far: GPT forward and next-token loss (``models.gpt``), and
KV-cache greedy generation through :func:`init_inference`.
"""

from __future__ import annotations

from typing import Any

from .accelerator import get_accelerator  # noqa: F401
from .utils.logging import log_dist, logger  # noqa: F401

__version__ = "0.1.0"


def init_inference(model: Any = None, config: Any = None, device=None, **kwargs):
    """Create an inference engine (counterpart of ``deepspeed_tpu.init_inference``).

    ``model`` is an adapter from ``inference.engine.for_gpt`` or a
    ``models.gpt.GPTModel``; ``config`` a dict of the reference's JSON keys
    or a ``DeepSpeedInferenceConfig``, extended by ``kwargs``. ``device``
    defaults to the CUDA device and raises when there is none."""
    from .inference.config import DeepSpeedInferenceConfig
    from .inference.engine import InferenceEngine, for_gpt
    from .models.gpt import GPTModel, unported

    if isinstance(config, DeepSpeedInferenceConfig):
        if kwargs:
            raise TypeError("pass either a DeepSpeedInferenceConfig or keyword "
                            "options, not both")
        inf_cfg = config
    else:
        inf_cfg = DeepSpeedInferenceConfig.from_dict({**(config or {}), **kwargs})
    if model is None or inf_cfg.checkpoint is not None:
        raise unported("loading an on-disk checkpoint in init_inference", "A13")
    if isinstance(model, GPTModel):
        model = for_gpt(model.cfg, model.params())
    elif (hasattr(model, "state_dict") and hasattr(model, "config")
          and not hasattr(model, "prefill")):
        raise unported("importing a Hugging Face model in init_inference", "A13")
    return InferenceEngine(model, inf_cfg, device=device)
