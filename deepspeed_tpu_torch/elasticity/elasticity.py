"""Elastic training batch math (counterpart of
``deepspeed_tpu/elasticity/elasticity.py``, itself DeepSpeed's elasticity
v0.1/0.2): given an acceptable-batch-size
ceiling and a set of micro-batch sizes, find a global batch size that remains
valid (batch = micro x gas x world) across a whole RANGE of world sizes, so a
preempted/resized job resumes without changing the effective batch.

The algorithm is the reference's: candidate global batch sizes are each
micro-batch scaled by powers of two up to the ceiling; a world size is valid for
a candidate if the candidate divides by (micro x world) for some micro; the
chosen candidate maximizes the number of valid world sizes, tie-broken by the
preference for larger batch.

Pure host math: "world" is a device count (the elastic agent's
``probe_device_count``), and the block's range keys are
``min_world_size`` / ``max_world_size``, with DeepSpeed's ``min_gpus`` /
``max_gpus`` accepted as aliases. :func:`validate_elasticity_block` is the ONE validation both the
runtime config (``runtime/config.py``) and the agent resolve through;
:func:`elastic_ladder` enumerates the resulting valid
``(world, micro, gas)`` decompositions.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

LATEST_ELASTICITY_VERSION = 0.2
MINIMUM_DEEPSPEED_VERSION = "0.3.8"

# the resource scheduler exports the elastic config it scaled the job by;
# runtime must refuse to train with a different one (the reference's
# DEEPSPEED_ELASTICITY_CONFIG, elasticity/elasticity.py:254). The reference
# spelling is accepted too so imported launch scripts keep working.
ELASTICITY_CONFIG_ENV = "DS_TPU_ELASTICITY_CONFIG"
_ELASTICITY_CONFIG_ENV_COMPAT = "DEEPSPEED_ELASTICITY_CONFIG"


class ElasticityError(Exception):
    """Parity: ``elasticity/elasticity.py`` error types (collapsed)."""


def elasticity_enabled(ds_config: Dict[str, Any]) -> bool:
    """Parity: ``elasticity.py:248``."""
    return bool(ds_config.get("elasticity", {}).get("enabled", False))


# the block's schema: the canonical keys plus DeepSpeed's spellings
# (accepted as aliases); anything else is a typo that would silently change
# the resize plan — rejected, not ignored
_KNOWN_KEYS = {
    "enabled", "max_train_batch_size", "micro_batch_sizes",
    "min_world_size", "max_world_size",          # canonical (world = devices)
    "min_gpus", "max_gpus",                      # reference aliases
    "prefer_larger_batch", "version", "ignore_non_elastic_batch_info",
    "min_time", "model_parallel_size", "num_gpus_per_node",  # accepted, inert
}
_INERT_KEYS = {"min_time", "model_parallel_size", "num_gpus_per_node"}


def world_bounds(e: Dict[str, Any]) -> Tuple[int, int]:
    """The valid world-size range: canonical ``min_world_size``/
    ``max_world_size``, falling back to the reference's gpu-keyed aliases."""
    lo = int(e.get("min_world_size", e.get("min_gpus", 1)))
    hi = int(e.get("max_world_size", e.get("max_gpus", 10000)))
    return lo, hi


def validate_elasticity_block(e: Dict[str, Any], warn=None) -> Dict[str, Any]:
    """Validate an ``elasticity`` block's shape and ranges; returns a
    normalized copy (canonical world keys resolved). Raises
    :class:`ElasticityError` with the exact offending knob — this is the one
    validation the runtime config AND the elastic agent go through, so a bad
    block dies at config load, not mid-resize."""
    if not isinstance(e, dict):
        raise ElasticityError(
            f"elasticity block must be a dict, got {type(e).__name__}")
    unknown = set(e) - _KNOWN_KEYS
    if unknown:
        raise ElasticityError(
            f"unknown elasticity keys {sorted(unknown)}; known: "
            f"{sorted(_KNOWN_KEYS)}")
    inert = sorted(set(e) & _INERT_KEYS)
    if inert and warn is not None:
        warn(f"elasticity keys {inert} accepted for reference-config "
             f"compatibility but inert")
    version = float(e.get("version", LATEST_ELASTICITY_VERSION))
    if version > LATEST_ELASTICITY_VERSION:
        raise ElasticityError(f"unsupported elasticity version {version}")
    max_batch = int(e.get("max_train_batch_size", 2000))
    if max_batch < 1:
        raise ElasticityError(
            f"max_train_batch_size must be >= 1, got {max_batch}")
    micro = e.get("micro_batch_sizes", [2, 4, 6])
    if not isinstance(micro, (list, tuple)) or not micro:
        raise ElasticityError(
            f"micro_batch_sizes must be a non-empty list, got {micro!r}")
    micro = [int(m) for m in micro]
    if any(m < 1 for m in micro):
        raise ElasticityError(
            f"micro_batch_sizes must be positive, got {micro}")
    if min(micro) > max_batch:
        raise ElasticityError(
            f"every micro batch in {micro} exceeds max_train_batch_size="
            f"{max_batch}: no candidate global batch exists")
    lo, hi = world_bounds(e)
    if lo < 1 or hi < lo:
        raise ElasticityError(f"invalid world-size range [{lo}, {hi}]")
    out = dict(e)
    out["micro_batch_sizes"] = micro
    out["max_train_batch_size"] = max_batch
    out["min_world_size"] = lo
    out["max_world_size"] = hi
    out["version"] = version
    return out


def _fingerprint(e: Dict[str, Any]) -> Dict[str, Any]:
    """The convergence-relevant knobs: changing any of these mid-job changes
    the effective batch schedule the scheduler planned resizes around."""
    return {
        "max_train_batch_size": int(e.get("max_train_batch_size", 2000)),
        "micro_batch_sizes": sorted(
            int(m) for m in e.get("micro_batch_sizes", [2, 4, 6])),
        "version": float(e.get("version", LATEST_ELASTICITY_VERSION)),
    }


def ensure_immutable_elastic_config(runtime_elastic_config: Dict[str, Any],
                                    warn=None) -> bool:
    """Refuse to run if the scheduler scaled this job with a DIFFERENT elastic
    config than the runtime is using (parity:
    ``ensure_immutable_elastic_config``, ``elasticity/elasticity.py:254``).

    Returns True when the fingerprint was verified, False when no scheduler
    config is present (warned — resizes are then unguaranteed)."""
    raw = (os.environ.get(ELASTICITY_CONFIG_ENV)
           or os.environ.get(_ELASTICITY_CONFIG_ENV_COMPAT))
    if raw is None:
        msg = (f"{ELASTICITY_CONFIG_ENV} not set: cannot guarantee the "
               "resource scheduler will resize this job at compatible "
               "worker counts")
        if warn is not None:
            warn(msg)
        else:
            import logging

            from ..utils.logging import log_dist

            log_dist(msg, level=logging.WARNING)
        return False
    try:
        sched = json.loads(raw)
    except ValueError as e:
        raise ElasticityError(
            f"{ELASTICITY_CONFIG_ENV} is not valid JSON: {e}") from e
    sched_fp = _fingerprint(sched.get("elasticity", sched))
    run_fp = _fingerprint(runtime_elastic_config)
    for k in sched_fp:
        if sched_fp[k] != run_fp[k]:
            raise ElasticityError(
                f"elastic config '{k}' seen by the resource scheduler "
                f"({sched_fp[k]}) does not match the runtime config "
                f"({run_fp[k]}) — the scheduler's resize plan would break "
                "the effective batch invariant")
    return True


def get_candidate_batch_sizes(base_list: List[int],
                              max_acceptable_batch_size: int) -> List[int]:
    """Each micro-batch size scaled by powers of 2 up to the ceiling."""
    candidates = set()
    for base in base_list:
        if base <= 0:
            raise ElasticityError(f"micro batch size must be positive, got {base}")
        b = base
        while b <= max_acceptable_batch_size:
            candidates.add(b)
            b *= 2
    return sorted(candidates)


def get_valid_world_sizes(batch_size: int, micro_batches: List[int],
                          min_world: int, max_world: int) -> List[int]:
    """World sizes at which ``batch_size`` decomposes as micro x gas x world."""
    valid = []
    for w in range(min_world, max_world + 1):
        for mb in micro_batches:
            if batch_size % (mb * w) == 0:
                valid.append(w)
                break
    return valid


# reference-spelling alias (torch-era name; world = device count here)
get_valid_gpus = get_valid_world_sizes


def _best_candidate(candidates: List[int], micro_batches: List[int],
                    min_gpus: int, max_gpus: int, prefer_larger: bool
                    ) -> Tuple[Optional[int], List[int]]:
    best_bs, best_gpus = None, []
    order = reversed(candidates) if prefer_larger else iter(candidates)
    for bs in order:
        gpus = get_valid_world_sizes(bs, micro_batches, min_gpus, max_gpus)
        if len(gpus) > len(best_gpus):
            best_bs, best_gpus = bs, gpus
    return best_bs, best_gpus


def compute_elastic_config(ds_config: Dict[str, Any], world_size: int = 0
                           ) -> Tuple[int, List[int], int]:
    """Resolve the elasticity block. Parity: ``elasticity.py:287``.

    Returns ``(final_batch_size, valid_world_sizes, micro_batch)`` where
    ``micro_batch`` is resolved only when ``world_size`` > 0 (0 = just planning).
    """
    e = dict(ds_config.get("elasticity", {}) if isinstance(ds_config, dict)
             else ds_config.elasticity or {})
    if not e.get("enabled", False):
        raise ElasticityError("elasticity block missing or disabled")
    e = validate_elasticity_block(e)
    # fingerprint check against the scheduler's copy BEFORE resolving: a
    # drifted config must fail loudly, not train at the wrong batch plan
    ensure_immutable_elastic_config(e)
    max_batch = e["max_train_batch_size"]
    micro_batches = e["micro_batch_sizes"]
    min_gpus, max_gpus = world_bounds(e)
    prefer_larger = bool(e.get("prefer_larger_batch", True))

    candidates = get_candidate_batch_sizes(micro_batches, max_batch)
    final_bs, valid_gpus = _best_candidate(
        candidates, micro_batches, min_gpus, max_gpus, prefer_larger)
    if final_bs is None:
        raise ElasticityError(
            f"no batch size <= {max_batch} works for micro batches {micro_batches} "
            f"over [{min_gpus}, {max_gpus}] workers")

    micro = -1
    if world_size > 0:
        if world_size not in valid_gpus:
            raise ElasticityError(
                f"world size {world_size} is not among the valid sizes {valid_gpus} "
                f"for elastic batch {final_bs}")
        # largest micro batch that divides (reference prefers larger micro)
        for mb in sorted(micro_batches, reverse=prefer_larger):
            if final_bs % (mb * world_size) == 0:
                micro = mb
                break
    return final_bs, valid_gpus, micro


def elastic_ladder(ds_config: Dict[str, Any]) -> List[Tuple[int, int, int]]:
    """The full resize plan: every valid ``(world, micro, gas)`` triple for
    the block's chosen elastic batch, ascending by world size. The one list
    the agent resolves launches from and the runtime config validates its
    batch triangle against. Resolves the block ONCE (one validation, one
    scheduler-fingerprint check) and selects each world's micro batch with
    the same largest-dividing rule ``compute_elastic_config`` applies."""
    final_bs, valid, _ = compute_elastic_config(ds_config, 0)
    e = validate_elasticity_block(dict(
        ds_config.get("elasticity", {}) if isinstance(ds_config, dict)
        else ds_config.elasticity or {}))
    prefer_larger = bool(e.get("prefer_larger_batch", True))
    ladder = []
    for w in valid:
        for mb in sorted(e["micro_batch_sizes"], reverse=prefer_larger):
            if final_bs % (mb * w) == 0:
                ladder.append((w, mb, final_bs // (mb * w)))
                break
    return ladder
