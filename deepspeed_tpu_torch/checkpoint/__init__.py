"""Checkpoint save and load (counterpart of ``deepspeed_tpu/checkpoint``).

The format is the reference's universal one, and each package loads the
other's tags: a tag directory holds ``state/`` (every train-state leaf as
its full logical array, :mod:`.serialization`), ``grad_acc/`` when it was
saved inside an accumulation window, ``meta.json`` (the counters, the data
cursor, ``client_state`` and the config), a copy of ``zero_to_fp32.py``,
and the commit protocol's ``MANIFEST.json`` and ``COMMIT``
(:mod:`..resilience.manifest`); ``latest`` beside the tags names the newest.

Under ZeRO stage 3 a save joins every rank's slices into the full leaves
(a collective: every rank calls it) and rank 0 writes; a load cuts the full
leaves to this rank's slices. A tag written at another world size raises
ROADMAP.md A9b (reshard-on-load), one with offload state A12.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import bridge
from ..comm import comm
from ..resilience import (
    RetryingWriter,
    commit_tag,
    invalidate_tag,
    resolve_tag_for_load,
    write_latest,
)
from ..resilience.manifest import CheckpointCorruptionError
from ..runtime.zero.reshard import partition_record
from ..utils.errors import unported
from ..utils.logging import log_dist, logger
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from .serialization import (
    flatten_with_paths,
    leaf_to_numpy,
    load_pytree,
    map_with_paths,
    save_pytree,
)

# the reference's offload state inside a tag (ROADMAP.md A12)
_OFFLOAD_FILES = ("host_state", "host_optimizer.npz")


def _tag_for(step: int) -> str:
    return f"global_step{step}"


def _validate_tag(tag: str, device) -> None:
    """Every rank must save under the same tag: their digests are compared."""
    if comm.get_world_size() == 1:
        return
    digest = torch.frombuffer(bytearray(hashlib.sha256(tag.encode()).digest()),
                              dtype=torch.uint8).to(device)
    every = comm.all_gather(digest, axis=0, tiled=False)
    if not bool((every == digest).all()):
        raise ValueError(f"checkpoint tag differs across ranks (local: {tag!r})")


def _get_ckpt_engine(engine):
    if engine._ckpt_engine is None:
        from ..runtime.checkpoint_engine import get_checkpoint_engine

        engine._ckpt_engine = get_checkpoint_engine(engine.config)
    return engine._ckpt_engine


def _grad_acc_tree(engine):
    """The open accumulation window's gradients as the params-shaped fp32
    tree the reference saves, every rank's slices joined (a collective)."""
    tree = tree_unflatten(engine.state["params"], engine._grad_acc)
    return bridge.join_tree(tree, engine.param_specs)


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[dict] = None, save_latest: bool = True) -> str:
    """A crash-consistent tagged save, in the reference's order: the old
    ``COMMIT`` revoked, the state, the accumulation buffer, ``meta.json``,
    the ``zero_to_fp32.py`` copy, the checkpoint engine's commit, the
    manifest and ``COMMIT``, ``latest``, a barrier. Returns the tag's
    directory."""
    tag = tag or _tag_for(int(engine.state["step"]))
    _validate_tag(tag, engine.device)
    ckpt_engine = _get_ckpt_engine(engine)
    ckpt_engine.create(tag)
    ckpt_dir = os.path.join(save_dir, tag)
    is_writer = comm.get_rank() == 0
    if is_writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        # a re-saved tag is uncommitted for the whole rewrite
        invalidate_tag(ckpt_dir)
    state = bridge.join_state(engine.state, engine.param_specs)
    mid_accum = engine._grad_acc is not None and engine._micro > 0
    grad_acc = _grad_acc_tree(engine) if mid_accum else None
    if is_writer:
        writer = getattr(ckpt_engine, "save_array", None)
        save_pytree(state, os.path.join(ckpt_dir, "state"), file_writer=writer)
        if mid_accum:
            save_pytree(grad_acc, os.path.join(ckpt_dir, "grad_acc"), file_writer=writer)
        part = partition_record(engine)
        meta = {
            "tag": tag,
            "has_grad_acc": mid_accum,
            "world_size": part["dp"],
            "partition": part,
            "global_steps": engine.global_steps,
            "micro_steps": engine.micro_steps,
            "skipped_steps": engine.skipped_steps,
            "data_cursor": int(engine.data_cursor),
            "client_state": client_state or {},
            "ds_config": engine.config.to_dict(),
            # no host PRNG chain: the port's dropout seeds are
            # fold_in(seed, micro_steps), restored from "seed" and "micro_steps"
            "rng_key": None,
            "saved_unix_time": time.time(),
            "emergency": False,  # the emergency drain and its counters are A11
            "preemptions_survived": 0,
            "resume_state": None,
            "seed": int(engine.seed),
        }
        RetryingWriter().write_bytes(os.path.join(ckpt_dir, "meta.json"),
                                     json.dumps(meta, indent=2, default=str).encode(),
                                     fsync=False)
        # the standalone recovery script beside the data, as the reference copies it
        try:
            from ..utils import zero_to_fp32

            shutil.copyfile(zero_to_fp32.__file__, os.path.join(ckpt_dir, "zero_to_fp32.py"))
        except OSError as e:  # a convenience copy never fails a save
            log_dist(f"zero_to_fp32.py copy skipped: {e}")
    # durability point 1: the checkpoint engine's queued writes are done
    ckpt_engine.commit(tag)
    if is_writer:
        # durability point 2: fsync, MANIFEST.json, COMMIT; only then latest
        retrier = RetryingWriter()
        commit_tag(ckpt_dir, retrier, tag=tag)
        if save_latest:
            write_latest(save_dir, tag, retrier)
    comm.barrier()
    log_dist(f"saved checkpoint {ckpt_dir} (committed)")
    return ckpt_dir


def _full_template(tree, specs, world: int):
    """Meta tensors of the full logical shapes of a parameter-shaped tree of
    slices (a leaf cut along ``d`` is ``world`` times longer there)."""
    def full(t, d):
        shape = list(t.shape)
        if d is not None:
            shape[d] *= world
        return torch.empty(shape, dtype=t.dtype, device="meta")

    return tree_map(full, tree, specs)


def _cut_tree(tree, engine):
    """This rank's slices of a parameter-shaped tree of full CPU tensors."""
    policy = engine.zero_policy
    return tree_map(lambda t, d: t if d is None else policy.shard(t, d).clone(), tree,
                    engine.param_specs)


def _to_device(tree, device):
    return map_with_paths(lambda _, t: t.to(device), tree)


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True) -> Tuple[Optional[str], Dict[str, Any]]:
    """A verified load: every candidate tag is checked against its manifest
    (``COMMIT`` present, each file's bytes and checksum) before any engine
    state changes. ``tag=None`` takes ``latest`` and falls back to the
    newest committed tag that verifies; an explicit ``tag`` is verified
    strictly and raises :class:`CheckpointCorruptionError`. Returns (the
    tag's directory, its ``client_state``), or (None, {}) where
    ``load_dir`` holds no committed tag. ``load_optimizer_states=False``
    keeps the engine's optimizer state and master copy."""
    if tag is not None and not os.path.isdir(os.path.join(load_dir, tag)):
        raise FileNotFoundError(f"checkpoint {os.path.join(load_dir, tag)} not found")
    resolved, rejected = resolve_tag_for_load(load_dir, tag, deep=True)
    if resolved is None:
        log_dist(f"no committed checkpoint at {load_dir}; nothing loaded")
        return None, {}
    for bad_tag, reason in rejected:
        logger.error(f"load_checkpoint: tag {bad_tag!r} rejected ({reason}); falling back to "
                     f"newest committed tag {resolved!r}")
    ckpt_dir = os.path.join(load_dir, resolved)
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        meta = json.load(f)
    old_world = meta.get("world_size")
    if old_world is not None and int(old_world) != engine.world_size:
        raise unported(f"loading a tag written at world size {old_world} at world size "
                       f"{engine.world_size} (reshard-on-load)", "A9b")
    if any(os.path.exists(os.path.join(ckpt_dir, n)) for n in _OFFLOAD_FILES):
        raise unported("loading a tag with ZeRO-Offload host state", "A12")

    world = engine.world_size
    template = bridge.map_param_trees(
        engine.state, lambda tree: _full_template(tree, engine.param_specs, world))
    state = load_pytree(template, os.path.join(ckpt_dir, "state"))
    state = _to_device(bridge.map_param_trees(state, lambda tree: _cut_tree(tree, engine)),
                       engine.device)
    if not load_optimizer_states:
        state = {**state, "opt": engine.state["opt"], "master": engine.state["master"]}
    grad_acc = None
    if meta.get("has_grad_acc"):
        acc_template = tree_map(lambda t: t.float(), _full_template(
            engine.state["params"], engine.param_specs, world))
        acc = load_pytree(acc_template, os.path.join(ckpt_dir, "grad_acc"))
        grad_acc = tree_leaves(_to_device(_cut_tree(acc, engine), engine.device))
    engine.load_state(state)
    engine._grad_acc = grad_acc
    engine.global_steps = int(meta.get("global_steps", 0))
    engine.micro_steps = int(meta.get("micro_steps", 0))
    engine.skipped_steps = int(meta.get("skipped_steps", 0))
    engine.data_cursor = int(meta.get("data_cursor",
                                      engine.global_steps + engine.skipped_steps))
    engine.seed = int(meta.get("seed", engine.seed))
    log_dist(f"loaded checkpoint {ckpt_dir}")
    return ckpt_dir, meta.get("client_state", {})


def save_16bit_model(engine, save_dir: str, save_filename: str = "pytorch_model.npz") -> str:
    """The compute-dtype parameters in one ``.npz``, as the reference writes
    it: a bf16 leaf as ``<key>::bfloat16`` holding the uint16 view of its
    bits. Under ZeRO stage 3 the gather of the full model must be asked for
    with ``stage3_gather_16bit_weights_on_model_save``, as in the reference.
    A collective at stage 3; rank 0 writes. Returns the file's path."""
    zc = engine.config.zero_optimization
    if engine.zero_policy.stage == 3 and not zc.stage3_gather_16bit_weights_on_model_save:
        raise ValueError(
            "save_16bit_model under ZeRO-3 requires "
            "stage3_gather_16bit_weights_on_model_save=true (the gather "
            "materializes the full model on host)")
    params = bridge.join_tree(engine.state["params"], engine.param_specs)
    path = os.path.join(save_dir, save_filename)
    if comm.get_rank() == 0:
        os.makedirs(save_dir, exist_ok=True)
        out = {}
        for key, leaf in flatten_with_paths(params):
            arr, dtype_name, raw_view = leaf_to_numpy(leaf)
            out[f"{key}::{dtype_name}" if raw_view else key] = arr
        np.savez(path, **out)
    return path


__all__ = ["save_checkpoint", "load_checkpoint", "save_16bit_model", "save_pytree",
           "load_pytree", "CheckpointCorruptionError"]
