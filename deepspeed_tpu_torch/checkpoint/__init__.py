"""Checkpoint save and load (counterpart of ``deepspeed_tpu/checkpoint``).

The format is the reference's universal one, and each package loads the
other's tags: a tag directory holds ``state/`` (every train-state leaf as
its full logical array, :mod:`.serialization`), ``grad_acc/`` when it was
saved inside an accumulation window, ``meta.json`` (the counters, the data
cursor, ``client_state`` and the config), a copy of ``zero_to_fp32.py``,
and the commit protocol's ``MANIFEST.json`` and ``COMMIT``
(:mod:`..resilience.manifest`); ``latest`` beside the tags names the newest.

Under ZeRO a save joins every rank's slices into the full leaves (a
collective: every rank calls it), and the error-feedback residuals' rows
into the reference's global ``[W, npad]`` / ``[L, W, npad_l]`` arrays, and
rank 0 writes; a load cuts the full leaves to this rank's slices. The
format is topology-free, so a tag written at another world size loads too
(reshard-on-load, :mod:`..runtime.zero.reshard`): the logical leaves are
cut to the new slices, the residuals reset to zeros of the new shape, the
data cursor remapped, and a mid-accumulation window dropped for the new
decomposition to consume again from its start.

Under ZeRO-Offload / ZeRO-Infinity the fp32 masters and moments live on the
offload runner: a save writes them before the MANIFEST + COMMIT pass, which
then covers them, as per-unit atomic ``host_state/shard_<k>.npz`` files with
a ``host-shard`` fault point between them (RAM mode), or as the consolidated
``host_optimizer.npz`` (NVMe mode); a load restores either, and a tag of the
parameter stream keeps its weights only there, so it refuses
``load_optimizer_states=False``. Host state crosses with the JAX package's
tags both ways.

A save passes the chaos plan's fault points (``begin-save``, ``shard`` after
each array, the commit's three, ``pre-latest``, ``end-save``), writes
``emergency`` (a drain's save), ``preemptions_survived`` and the
``resume_state`` of the engine's ``resume_state_provider``; a load restores
them (``engine.resumed_state``) and records ``preemption_survived``,
``resume_latency_s``, ``tag_rejected_on_load`` and ``reshard_applied`` in
the engine's recovery log.
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
    fault_point,
    invalidate_tag,
    resolve_tag_for_load,
    write_latest,
)
from ..resilience.manifest import CheckpointCorruptionError
from ..runtime.zero.reshard import (
    RESIDUAL_RANK_AXIS,
    apply_cursor_reshard,
    get_path,
    load_resolver,
    partition_record,
    set_path,
)
from ..utils.logging import log_dist, logger
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from .serialization import (
    flatten_with_paths,
    leaf_to_numpy,
    load_pytree,
    map_with_paths,
    save_pytree,
)

# the offload runners' host state inside a tag
HOST_OPTIMIZER_FILE = "host_optimizer.npz"


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
    tree the reference saves: reduced over the ranks (below stage 3 each
    rank holds its own rows' sum until the boundary) and every rank's
    slices joined (a collective)."""
    acc = engine._grad_acc
    if (engine.world_size > 1 and engine.zero_policy.stage < 3
            and not engine._qgrad_live):
        acc = [comm.all_reduce(g, op="mean") for g in acc]
    return bridge.join_tree(tree_unflatten(engine.state["params"], acc), engine.param_specs)


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[dict] = None, save_latest: bool = True) -> str:
    """A crash-consistent tagged save, in the reference's order: the old
    ``COMMIT`` revoked, the state, the accumulation buffer, ``meta.json``,
    the ``zero_to_fp32.py`` copy, the checkpoint engine's commit, the
    manifest and ``COMMIT``, ``latest``, a barrier. Returns the tag's
    directory."""
    tag = tag or _tag_for(int(engine.state["step"]))
    _validate_tag(tag, engine.device)
    fault_point("begin-save")
    ckpt_engine = _get_ckpt_engine(engine)
    ckpt_engine.create(tag)
    ckpt_dir = os.path.join(save_dir, tag)
    is_writer = comm.get_rank() == 0
    if is_writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        # a re-saved tag is uncommitted for the whole rewrite
        invalidate_tag(ckpt_dir)
    state = bridge.join_state(engine.state, engine.param_specs, engine.opt_specs)
    mid_accum = engine._grad_acc is not None and engine._micro > 0
    grad_acc = _grad_acc_tree(engine) if mid_accum else None
    if is_writer:
        writer = getattr(ckpt_engine, "save_array", None)
        save_pytree(state, os.path.join(ckpt_dir, "state"), file_writer=writer)
        if mid_accum:
            save_pytree(grad_acc, os.path.join(ckpt_dir, "grad_acc"), file_writer=writer)
        part = partition_record(engine)
        resume_state = None
        provider = getattr(engine, "resume_state_provider", None)
        if provider is not None:
            try:
                resume_state = provider()
            except Exception as e:  # a dataloader hook must not kill a drain's save
                logger.warning(f"resume_state_provider failed: {e}")
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
            "emergency": bool(getattr(engine, "_draining", False)),
            "preemptions_survived": int(getattr(engine, "_preemptions_survived", 0)),
            "resume_state": resume_state,
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
    runner = engine._offload or engine._param_stream
    if runner is not None and is_writer:
        # the host masters and moments, before the manifest hashes the tag
        from ..runtime.zero.stream import HOST_STATE_DIRNAME

        if runner.master is None:  # a save before the first step
            runner.init_host_state()
        if not runner.flush_host_shards(os.path.join(ckpt_dir, HOST_STATE_DIRNAME)):
            ckpt_engine.save(runner.host_state_dict(),
                             os.path.join(ckpt_dir, HOST_OPTIMIZER_FILE))
    # durability point 1: the checkpoint engine's queued writes are done
    ckpt_engine.commit(tag)
    if is_writer:
        # durability point 2: fsync, MANIFEST.json, COMMIT; only then latest
        retrier = RetryingWriter()
        commit_tag(ckpt_dir, retrier, tag=tag)
        fault_point("pre-latest", tag_dir=ckpt_dir)
        if save_latest:
            write_latest(save_dir, tag, retrier)
    comm.barrier()
    fault_point("end-save", tag_dir=ckpt_dir)
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


def _cut_tree(tree, engine, specs):
    """This rank's slices of a parameter-shaped tree of full CPU tensors."""
    policy = engine.zero_policy
    return tree_map(lambda t, d: t if d is None else policy.shard(t, d).clone(), tree, specs)


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
    if engine._param_stream is not None and not load_optimizer_states:
        # checked before anything changes: the weights live in the host state
        raise ValueError("offload_param checkpoints keep the weights inside the host master "
                         "state; load_optimizer_states=False would restore no weights")
    if tag is not None and not os.path.isdir(os.path.join(load_dir, tag)):
        raise FileNotFoundError(f"checkpoint {os.path.join(load_dir, tag)} not found")
    res = getattr(engine.config, "resilience", None)
    resolved, rejected = resolve_tag_for_load(load_dir, tag,
                                              deep=bool(getattr(res, "deep_verify", True)))
    if resolved is None:
        log_dist(f"no committed checkpoint at {load_dir}; nothing loaded")
        return None, {}
    rec = getattr(engine, "_recovery_log", None)
    for bad_tag, reason in rejected:
        logger.error(f"load_checkpoint: tag {bad_tag!r} rejected ({reason}); falling back to "
                     f"newest committed tag {resolved!r}")
        if rec is not None:
            rec.record("tag_rejected_on_load", step=engine.global_steps, tag=bad_tag,
                       reason=reason)
    ckpt_dir = os.path.join(load_dir, resolved)
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        meta = json.load(f)
    runner = engine._offload or engine._param_stream
    host_dir, host_file = _host_state_paths(ckpt_dir)
    if runner is not None and load_optimizer_states and host_dir is None and host_file is None:
        raise FileNotFoundError(f"checkpoint {ckpt_dir} has no host_state/ shards or "
                                "host_optimizer.npz but the engine runs ZeRO-Offload; pass "
                                "load_optimizer_states=False to restart the optimizer "
                                "deliberately")
    world = engine.world_size
    old_world = int(meta.get("world_size") or world)
    resharding = old_world != world

    def full(tree, specs):
        return _full_template(tree, specs, world)

    template = bridge.map_param_trees(engine.state, lambda t: full(t, engine.param_specs),
                                      lambda t: full(t, engine.opt_specs))
    for key, axis in RESIDUAL_RANK_AXIS.items():
        row = get_path(engine.state, key)
        if row is not None:
            shape = list(row.shape)
            shape[axis] *= world
            set_path(template, key, torch.empty(shape, dtype=torch.float32, device="meta"))
    state = load_pytree(template, os.path.join(ckpt_dir, "state"),
                        on_shape_mismatch=load_resolver(
                            old_world, world, recovery_log=rec,
                            step=int(meta.get("global_steps", 0))) if resharding else None)
    state = bridge.map_param_trees(state, lambda t: _cut_tree(t, engine, engine.param_specs),
                                   lambda t: _cut_tree(t, engine, engine.opt_specs))
    for key, axis in RESIDUAL_RANK_AXIS.items():
        if get_path(state, key) is not None:
            set_path(state, key, engine.zero_policy.shard(get_path(state, key), axis).clone())
    state = _to_device(state, engine.device)
    if not load_optimizer_states:
        state = {**state, "opt": engine.state["opt"], "master": engine.state["master"]}
    grad_acc = None
    if meta.get("has_grad_acc") and not resharding:
        acc_template = tree_map(lambda t: t.float(), full(engine.state["params"],
                                                          engine.param_specs))
        acc = load_pytree(acc_template, os.path.join(ckpt_dir, "grad_acc"))
        grad_acc = tree_leaves(_to_device(_cut_tree(acc, engine, engine.param_specs),
                                          engine.device))
    elif meta.get("has_grad_acc"):
        # another decomposition's partial window cannot be continued: it is
        # dropped, and the window is consumed again from its start
        state["micro"] = torch.zeros_like(state["micro"])
    cursor = int(meta.get("data_cursor", int(meta.get("global_steps", 0))
                          + int(meta.get("skipped_steps", 0))))
    plan = None
    if resharding:  # refused (ReshardError) before anything changes
        before, engine.data_cursor = engine.data_cursor, cursor
        try:
            plan = apply_cursor_reshard(engine, meta, old_world)
        finally:
            engine.data_cursor = before
        cursor = plan.new_cursor
    engine.load_state(state)
    engine._grad_acc = grad_acc
    engine.global_steps = int(meta.get("global_steps", 0))
    engine.micro_steps = int(meta.get("micro_steps", 0))
    engine.skipped_steps = int(meta.get("skipped_steps", 0))
    engine.data_cursor = cursor
    engine.seed = int(meta.get("seed", engine.seed))
    if plan is not None:
        logger.warning(f"load_checkpoint: resharded tag {resolved!r} from world={old_world} to "
                       f"world={world} (cursor {plan.old_cursor} -> {plan.new_cursor}"
                       + (", mid-accumulation window rewound" if plan.window_rewound else "")
                       + ")")
        if rec is not None:
            rec.record("reshard_applied", step=engine.global_steps, tag=resolved,
                       old_world=old_world, new_world=plan.new_world,
                       old_cursor=plan.old_cursor, new_cursor=plan.new_cursor,
                       window_rewound=plan.window_rewound)
    if runner is not None and load_optimizer_states:
        if runner.master is None:
            runner.init_host_state(for_load=True)
        if host_dir is not None:
            runner.load_host_shards_dir(host_dir)
        else:  # the consolidated format (NVMe stores, older tags)
            with np.load(host_file) as d:
                runner.load_host_state_dict(dict(d))
    engine.resumed_state = meta.get("resume_state")
    # the counter rides every tag; an emergency tag adds the preemption it survived
    engine._preemptions_survived = int(meta.get("preemptions_survived", 0))
    if meta.get("emergency"):
        engine._preemptions_survived += 1
        if rec is not None:
            rec.record("preemption_survived", value=engine._preemptions_survived,
                       step=engine.global_steps, tag=resolved)
            saved_at = meta.get("saved_unix_time")
            if saved_at is not None:
                rec.record("resume_latency_s", value=max(0.0, time.time() - float(saved_at)),
                           step=engine.global_steps, tag=resolved)
    log_dist(f"loaded checkpoint {ckpt_dir}")
    return ckpt_dir, meta.get("client_state", {})


def _host_state_paths(ckpt_dir: str) -> Tuple[Optional[str], Optional[str]]:
    """(the ``host_state/`` shard directory, the ``host_optimizer.npz``
    file) of a tag, each None where absent."""
    from ..runtime.zero.stream import HOST_STATE_DIRNAME

    host_dir = os.path.join(ckpt_dir, HOST_STATE_DIRNAME)
    host_file = os.path.join(ckpt_dir, HOST_OPTIMIZER_FILE)
    return (host_dir if os.path.isdir(host_dir) else None,
            host_file if os.path.exists(host_file) else None)


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
