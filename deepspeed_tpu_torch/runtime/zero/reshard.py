"""Reshard-on-load: the flat-shard math, the data-cursor remap and the reset
of world-coupled state when a tag loads at another world size (counterpart
of ``deepspeed_tpu/runtime/zero/reshard.py``).

- :func:`partition_flat` / :func:`merge_flat` / :func:`repartition_flat`:
  the canonical flat-padded layout (rank ``i`` owns ``[i*s, (i+1)*s)`` of the
  logical vector padded with zeros to ``W*s``, ``s = ceil(n/W)``).
  ``repartition_flat`` only moves memory, so ``repartition(partition(x, N),
  M) == partition(x, M)`` bitwise for any dtype and any uneven size.
- :func:`rescale_cursor`: the data cursor counts consumed global batches;
  it is world-invariant while the global batch stays the same, is otherwise
  rescaled exactly in samples, and a remap that would split a global batch
  (drop or replay samples) raises :class:`ReshardError`.
- :func:`load_resolver`: what a load does with a leaf whose stored shape
  differs from the engine's. The error-feedback residuals of the quantized
  gradient exchange (:data:`RESIDUAL_RESET_KEYS`) and of the 1-bit
  optimizers (:data:`ONEBIT_RESET_KEYS`) hold per-rank quantization error
  against the old decomposition's chunks (the 1-bit buffers are also padded
  to a multiple of ``world * 8``), so they are reset to zeros of the new
  shape; any other leaf raises.
- :func:`apply_cursor_reshard`: the cursor remap after such a load
  (``checkpoint.load_checkpoint``). A mid-accumulation tag's partial window
  cannot be continued by another decomposition: the loader drops it and the
  cursor keeps pointing at the window, which is consumed again from its
  start.

The checkpoint format is topology-free (every leaf stored whole), so the
logical leaves load at any world size by cutting each to the new slices.
:func:`partition_host_state` / :func:`repartition_host_state` do the same for
the offload runners' host state (every ``master_<i>`` / ``m_<i>`` / ``v_<i>``
leaf flat-partitioned, scalars such as ``count`` passed through). A reset
residual is recorded as a ``reshard_residual_reset`` recovery event (and the
load records ``reshard_applied``) when the engine keeps a recovery log.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np

from ...utils.logging import logger

#: state keys reset at a world change (per-rank quantization error), the
#: reference's
RESIDUAL_RESET_KEYS = ("qgrad_residual", "qgrad_bucket_residual")

#: the 1-bit optimizers' residuals (``onebit/...``), reset too: their rows
#: are also padded to a multiple of ``world * 8`` (the reference's resolver
#: refuses them at another world size)
ONEBIT_RESET_KEYS = ("worker_error", "server_error")

#: the key path of each residual in the train state and its axis that
#: indexes the ranks: a rank holds one row of it, and a checkpoint stores the
#: reference's global shape
RESIDUAL_RANK_AXIS = {"qgrad_residual": 0, "qgrad_bucket_residual": 1,
                      "onebit/worker_error": 0, "onebit/server_error": 0}


def get_path(tree: Dict[str, Any], path: str):
    """The leaf at a ``/``-separated key path of nested dicts, or None."""
    node: Any = tree
    for part in path.split("/"):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def set_path(tree: Dict[str, Any], path: str, value) -> None:
    """Put ``value`` at ``path`` in ``tree``, copying the nested dicts on
    the way (the caller's top-level dict is the only one changed)."""
    parts = path.split("/")
    node = tree
    for part in parts[:-1]:
        node[part] = dict(node.get(part) or {})
        node = node[part]
    node[parts[-1]] = value

#: partition layout identifier recorded in checkpoint meta
PARTITION_FORMAT = "flat-padded-v1"


class ReshardError(ValueError):
    """A world-size remap that cannot be performed exactly."""


# ------------------------------------------------------------------ flat math
def shard_len(logical_size: int, world: int) -> int:
    """Per-rank shard length: ``ceil(logical/world)`` (the padded layout)."""
    if world < 1:
        raise ReshardError(f"world size must be >= 1, got {world}")
    if logical_size < 0:
        raise ReshardError(f"logical size must be >= 0, got {logical_size}")
    return -(-logical_size // world) if logical_size else 0


def partition_flat(flat: np.ndarray, world: int) -> np.ndarray:
    """A 1-D logical vector as ``[world, shard_len]`` contiguous shards, the
    tail rank zero-padded. Only memory moves: bitwise."""
    flat = np.ascontiguousarray(flat)
    if flat.ndim != 1:
        raise ReshardError(f"partition_flat takes a 1-D vector, got shape {flat.shape} "
                           "(ravel the leaf first)")
    s = shard_len(flat.size, world)
    padded = np.zeros(world * s, dtype=flat.dtype)
    padded[:flat.size] = flat
    return padded.reshape(world, s)


def merge_flat(shards: np.ndarray, logical_size: int) -> np.ndarray:
    """``[world, shard_len]`` shards merged into the logical vector, the tail
    padding dropped."""
    shards = np.asarray(shards)
    if shards.ndim != 2:
        raise ReshardError(f"merge_flat takes [world, shard] stacks, got shape {shards.shape}")
    if shards.size < logical_size:
        raise ReshardError(f"shards hold {shards.size} elements < logical size {logical_size}")
    return np.ascontiguousarray(shards.reshape(-1)[:logical_size])


def repartition_flat(shards: np.ndarray, new_world: int, logical_size: int) -> np.ndarray:
    """``[old_world, s_old]`` shards remapped to ``[new_world, s_new]``:
    bitwise a fresh partition of the merged vector; no float operation runs."""
    return partition_flat(merge_flat(shards, logical_size), new_world)


# ------------------------------------------------------------------- cursor
def rescale_cursor(cursor: int, old_global_batch: int, new_global_batch: int) -> int:
    """A data cursor (consumed global batches) remapped across a global-batch
    change, exactly in samples; a remap that would land inside a new global
    batch raises."""
    cursor, old_global_batch, new_global_batch = (int(cursor), int(old_global_batch),
                                                  int(new_global_batch))
    if old_global_batch <= 0 or new_global_batch <= 0:
        raise ReshardError(f"global batch sizes must be positive (old={old_global_batch}, "
                           f"new={new_global_batch})")
    if old_global_batch == new_global_batch:
        return cursor
    samples = cursor * old_global_batch
    if samples % new_global_batch:
        raise ReshardError(
            f"cursor {cursor} x old global batch {old_global_batch} = {samples} consumed "
            f"samples does not land on a new global-batch boundary ({new_global_batch}); "
            "resuming here would drop or replay samples: keep the effective batch constant "
            "across resizes")
    return samples // new_global_batch


# -------------------------------------------------------------- save-side meta
def engine_global_batch(engine) -> int:
    """Samples one data-cursor tick consumes on this engine (micro x gas x dp)."""
    return (int(getattr(engine, "micro_batch_size", 1) or 1)
            * int(getattr(engine, "gas", 1) or 1) * int(getattr(engine, "world_size", 1) or 1))


def partition_record(engine) -> Dict[str, Any]:
    """``{"format", "dp", "micro_batch", "gas", "global_batch"}`` of the
    engine, and with the quantized gradient exchange its flat geometry
    (``"qgrad": {"n", "npad"}``, and ``"qgrad_bucket": {"L", "npad"}`` for
    the per-layer buckets): the decomposition that wrote a tag."""
    dp = int(engine.world_size)
    micro = int(engine.micro_batch_size)
    gas = int(engine.gas)
    rec: Dict[str, Any] = {"format": PARTITION_FORMAT, "dp": dp, "micro_batch": micro,
                           "gas": gas, "global_batch": micro * gas * dp}
    if getattr(engine, "_qgrad_npad", None):
        rec["qgrad"] = {"n": int(engine._qgrad_n), "npad": int(engine._qgrad_npad)}
    if getattr(engine, "_qgrad_bucket_key", None):
        rec["qgrad_bucket"] = {"L": int(engine._qgrad_bucket_L),
                               "npad": int(engine._qgrad_bucket_npad)}
    return rec


# --------------------------------------------------------------- load-side
def load_resolver(old_world: int, new_world: int, recovery_log: Any = None,
                  step: int = 0) -> Callable[[str, Any, Any], Any]:
    """The ``on_shape_mismatch(key, stored, template_leaf)`` hook a load
    across world sizes passes to ``load_pytree``: a residual of
    :data:`RESIDUAL_RESET_KEYS` or :data:`ONEBIT_RESET_KEYS` comes back as zeros of the
    template's shape and dtype, recorded as a ``reshard_residual_reset``
    event in ``recovery_log``; any other leaf raises :class:`ReshardError`."""

    def resolve(key: str, stored, leaf):
        name = key.rsplit("/", 1)[-1]
        if name in RESIDUAL_RESET_KEYS + ONEBIT_RESET_KEYS:
            logger.warning(f"reshard: {key} reset to zeros {tuple(leaf.shape)} (written at "
                           f"world={old_world}, loading at world={new_world})")
            if recovery_log is not None:
                recovery_log.record("reshard_residual_reset", step=step, key=key,
                                    old_world=old_world, new_world=new_world)
            return np.zeros(tuple(leaf.shape), dtype=np.float32)
        raise ReshardError(
            f"checkpoint leaf {key!r} has shape {tuple(stored.shape)} (written at "
            f"world={old_world}) but the engine at world={new_world} expects "
            f"{tuple(leaf.shape)}: no reshard policy covers this leaf; it is world-coupled "
            "state this build does not know how to remap")

    return resolve


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """What a reshard-on-load decided."""

    old_world: int
    new_world: int
    old_cursor: int
    new_cursor: int
    window_rewound: bool


def apply_cursor_reshard(engine, meta: Dict[str, Any], old_world: int) -> ReshardPlan:
    """Remap ``engine.data_cursor`` after a load at another world size
    (called once the counters are restored from ``meta``): unchanged at the
    same global batch, rescaled sample-exactly otherwise, or refused. A
    mid-accumulation tag (``has_grad_acc``) keeps its cursor at the window,
    whose partial gradients the loader drops."""
    part = meta.get("partition") or {}
    old_global = int(part.get("global_batch") or 0)
    if old_global <= 0:  # tags without a partition record: the saved config's
        old_global = int((meta.get("ds_config") or {}).get("train_batch_size") or 0)
    old_cursor = new_cursor = int(engine.data_cursor)
    if old_global > 0:
        new_cursor = rescale_cursor(old_cursor, old_global, engine_global_batch(engine))
    engine.data_cursor = new_cursor
    return ReshardPlan(old_world=int(old_world), new_world=int(engine.world_size),
                       old_cursor=old_cursor, new_cursor=new_cursor,
                       window_rewound=bool(meta.get("has_grad_acc")))


__all__ = ["ReshardError", "ReshardPlan", "RESIDUAL_RESET_KEYS", "RESIDUAL_RANK_AXIS",
           "ONEBIT_RESET_KEYS", "partition_host_state", "repartition_host_state", "get_path", "set_path",
           "PARTITION_FORMAT", "shard_len", "partition_flat", "merge_flat", "repartition_flat",
           "rescale_cursor", "partition_record", "engine_global_batch", "load_resolver",
           "apply_cursor_reshard"]


def partition_host_state(host_state: Dict[str, np.ndarray], world: int
                         ) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """Every leaf of an offload host-state dict as ``[world, shard]`` stacks
    (:func:`partition_flat`), with the logical sizes to merge them back;
    0-dim counters are world-invariant and pass through (size 0)."""
    shards: Dict[str, np.ndarray] = {}
    sizes: Dict[str, int] = {}
    for key, arr in host_state.items():
        arr = np.asarray(arr)
        if arr.ndim == 0:
            shards[key], sizes[key] = arr, 0
            continue
        shards[key] = partition_flat(arr.reshape(-1), world)
        sizes[key] = int(arr.size)
    return shards, sizes


def repartition_host_state(shards: Dict[str, np.ndarray], sizes: Dict[str, int],
                           new_world: int) -> Dict[str, np.ndarray]:
    """Every partitioned host-state leaf remapped to ``new_world`` shards
    (:func:`repartition_flat`), scalars passed through."""
    out: Dict[str, np.ndarray] = {}
    for key, stack in shards.items():
        arr = np.asarray(stack)
        out[key] = arr if arr.ndim == 0 else repartition_flat(arr, new_world, sizes[key])
    return out
