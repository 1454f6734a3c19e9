"""The partition record a checkpoint's ``meta.json`` carries (counterpart of
``partition_record`` in ``deepspeed_tpu/runtime/zero/reshard.py``).

The checkpoint format is topology-free: every leaf is stored whole. The
record says which decomposition wrote a tag, so that a load at another
world size can remap the data cursor. Reshard-on-load itself (the cursor
remap, the mid-accumulation rewind, the reset of the error-feedback
residuals) is ROADMAP.md A9b: a load at another world size raises.
"""

from __future__ import annotations

from typing import Any, Dict

PARTITION_FORMAT = "flat-padded-v1"


def partition_record(engine) -> Dict[str, Any]:
    """``{"format", "dp", "micro_batch", "gas", "global_batch"}`` of the
    engine: the data-parallel world, and the samples one data-cursor tick
    consumes (micro x gas x dp)."""
    dp = int(engine.world_size)
    micro = int(engine.micro_batch_size)
    gas = int(engine.gas)
    return {"format": PARTITION_FORMAT, "dp": dp, "micro_batch": micro, "gas": gas,
            "global_batch": micro * gas * dp}
