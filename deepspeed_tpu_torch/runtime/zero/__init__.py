"""ZeRO (counterpart of ``deepspeed_tpu/runtime/zero``): the stage policy,
the stage-3 gathers, the user surface for partitioned parameters, reshard
on load, the memory estimators, and ZeRO-Offload / ZeRO-Infinity (the
runners of ``offload.py`` and ``infinity.py`` over ``stream.py``)."""

from ...utils.errors import unported
from .config import DeepSpeedZeroConfig  # noqa: F401
from .mem_estimator import (  # noqa: F401
    compiled_memory_analysis,
    estimate_zero2_model_states_mem_needs,
    estimate_zero2_model_states_mem_needs_all_cold,
    estimate_zero2_model_states_mem_needs_all_live,
    estimate_zero3_model_states_mem_needs,
    estimate_zero3_model_states_mem_needs_all_cold,
    estimate_zero3_model_states_mem_needs_all_live,
)
from .partitioned_params import GatheredParameters, Init  # noqa: F401
from .policy import ZeroShardingPolicy  # noqa: F401


def TiledLinear(*args, **kwargs):
    """``runtime/zero/tiling.py``'s tiled linear layer: not ported yet."""
    raise unported("runtime/zero/tiling.py TiledLinear", "A9c")
