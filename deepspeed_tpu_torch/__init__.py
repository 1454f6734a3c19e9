"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu``.

It runs on an NVIDIA H100; the kernels the JAX package wrote in Pallas for
the TPU are written here by hand in CUDA C++ for Hopper (``csrc/``), built by
``nvcc`` at first use. Every entry point runs on the CUDA device unless the
caller passes ``device="cpu"``, which takes the plain PyTorch versions of
the kernels. The package imports torch and numpy, never jax and nothing of
``deepspeed_tpu``.

Ported so far: GPT forward and next-token loss (``models.gpt``; ALiBi, local
attention and the chunked cross-entropy too), training through
:func:`initialize` (``DeepSpeedEngine.train_batch``; ZeRO stage 3 with the
quantized weight wire and LM head, data parallel over the ranks of
``comm.init_distributed``; the DeepSpeed data loader, the seqlen
curriculum, random-LTD, progressive layer drop, every remat policy, the
monitors, ``wall_clock_breakdown`` and the flops profiler; the 1-bit optimizers,
``compression_training`` and the eigenvalue probe), KV-cache generation (greedy, sampled or beam
search) through :func:`init_inference` (dense, or int8 / int4 weights with
``quant={"enabled": True, ...}``), continuous-batching paged serving
(``inference.serving``), and checkpointing
(``engine.save_checkpoint`` / ``load_checkpoint`` in the JAX package's
universal format, :mod:`.checkpoint`).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

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
    from .models.gpt import GPTModel
    from .utils.errors import unported

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


def initialize(args: Any = None, model: Any = None, optimizer: Any = None,
               model_parameters: Any = None, training_data: Any = None,
               lr_scheduler: Optional[Callable] = None, topology: Any = None,
               dist_init_required: Optional[bool] = None, config: Any = None,
               config_params: Any = None, seed: Optional[int] = None,
               device=None) -> Tuple[Any, Any, None, Callable]:
    """Create a training engine (counterpart of ``deepspeed_tpu.initialize``),
    with the reference's parameters in its order (``device`` after them) and
    its return arity ``(engine, optimizer, dataloader, lr_scheduler)``.

    ``model`` is a :class:`models.api.Module` (``models.gpt.build``);
    ``config`` a DeepSpeed JSON dict, a path or a ``DeepSpeedConfig``
    (``config_params`` is the legacy alias; without either,
    ``args.deepspeed_config``). ``optimizer`` overrides the config's and must
    be a port :class:`ops.optimizers.Optimizer`; ``lr_scheduler`` is a
    ``step -> lr`` callable. ``model_parameters`` is accepted and unused, as
    the reference's is (the model carries its parameters).
    ``dist_init_required`` None or True joins the process group of the
    ``WORLD_SIZE`` / ``RANK`` environment when it names more than one rank
    and none is joined yet (single-process runs need none, as in the
    reference); False leaves it to the caller (``comm.init_distributed``).
    ``training_data`` (a sequence of samples) gives a
    :class:`~.runtime.dataloader.DeepSpeedDataLoader` of global micro-batches,
    else the dataloader is None. The rule: every rank's loader yields the
    same global micro-batch of ``micro x world`` samples (one shared order,
    ``num_replicas`` 1), and the engine keeps rank r's block of rows, ``r *
    micro`` to ``(r + 1) * micro``, as it does for every batch it is handed.
    So rank r trains on the rows the reference's loader hands device r of
    its data-parallel mesh. ``topology`` (A13) raises: not ported.
    ``device`` defaults to the CUDA device and raises when there is none. The
    data-parallel world is the joined process group (one rank without it)."""
    import os

    from .comm import comm
    from .models.api import Module
    from .ops.optimizers import Optimizer
    from .runtime.config import DeepSpeedConfig
    from .runtime.engine import DeepSpeedEngine
    from .utils.errors import unported

    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is required")
    if topology is not None:
        raise unported("initialize(topology=...): a device mesh", "A13")
    if not isinstance(model, Module):
        raise TypeError("model must be a deepspeed_tpu_torch.models.api.Module "
                        f"(models.gpt.build gives one), got {type(model)}")
    if optimizer is not None and not isinstance(optimizer, Optimizer):
        raise TypeError("client optimizer must be a deepspeed_tpu_torch.ops.optimizers."
                        f"Optimizer (got {type(optimizer)})")
    cfg = config if config is not None else config_params
    if cfg is None and args is not None:
        cfg = getattr(args, "deepspeed_config", None)
    if ((dist_init_required is None or dist_init_required) and not comm.is_initialized()
            and int(os.environ.get("WORLD_SIZE", "1")) > 1):
        comm.init_distributed(device=device)
    ds_config = (cfg if isinstance(cfg, DeepSpeedConfig)
                 else DeepSpeedConfig.load(cfg, world_size=comm.get_world_size()))
    engine = DeepSpeedEngine(model, ds_config, seed=seed,
                             lr_scheduler_fn=lr_scheduler if callable(lr_scheduler) else None,
                             client_optimizer=optimizer, device=device)
    loader = None
    if training_data is not None:
        from .runtime.dataloader import DeepSpeedDataLoader

        loader = DeepSpeedDataLoader(training_data,
                                     batch_size=engine.micro_batch_size * engine.world_size,
                                     num_replicas=1, rank=0)
    return engine, engine.optimizer, loader, engine.lr_fn
