"""Train-state trees to and from the checkpoint layout (counterpart of
``deepspeed_tpu/checkpoint/serialization.py``).

One directory per tree:

- ``state.msgpack``: ``{"leaves": [{"key", "index", "shape", "dtype",
  "raw_view"}, ...], "format_version": 1}``;
- ``arrays/<index>.npy``: one file per leaf, the full logical array.

The format is the reference's, leaf for leaf: a leaf's key is its path of
dict keys and NamedTuple field names joined by ``/``, and leaves are
numbered in JAX's flatten order (dict keys sorted, NamedTuple fields in
field order, ``None`` fields skipped), so each package reads the other's
trees. numpy has no bfloat16: a bf16 leaf is stored as the uint16 view of
its bits with ``"dtype": "bfloat16", "raw_view": true``, as JAX stores it,
and read back as ``torch.bfloat16`` without passing through fp32.
"""

from __future__ import annotations

import os
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..resilience.retry import RetryingWriter
from . import msgpack_codec

#: state.msgpack layouts this build reads. Version 1: {leaves, format_version}.
KNOWN_FORMAT_VERSIONS = (1,)


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def map_with_paths(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """``fn(key, leaf)`` over every leaf of a tree of dicts and NamedTuples,
    keeping its structure (``None`` stays ``None``)."""
    def key(name):
        return f"{prefix}/{name}" if prefix else str(name)

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, key(k)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_paths(fn, v, key(f))
                            for f, v in zip(tree._fields, tree)))
    return fn(prefix, tree)


def flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in JAX's flatten order."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        if node is None:
            return
        if isinstance(node, dict):
            items = [(k, node[k]) for k in sorted(node)]
        elif _is_namedtuple(node):
            items = list(zip(node._fields, node))
        else:
            out.append((prefix, node))
            return
        for k, v in items:
            walk(v, f"{prefix}/{k}" if prefix else str(k))

    walk(tree, "")
    return out


def leaf_to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str, bool]:
    """(array to store, logical dtype name, raw_view) of a tensor. The
    array owns its memory (a background writer may hold it while training
    goes on); a bf16 tensor becomes the uint16 view of its bits."""
    t = leaf.detach()
    t = t.clone() if t.device.type == "cpu" else t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16", True
    arr = t.numpy()
    return arr, str(arr.dtype), False


def save_pytree(tree: Any, directory: str,
                file_writer: Optional[Callable[[str, np.ndarray], None]] = None) -> None:
    """Write ``tree``'s leaves (full logical tensors, on any device) under
    ``directory``. ``file_writer(path, array)`` is the checkpoint engine's
    (default: an atomic tmp + ``os.replace`` write). The fsync and the
    manifest are the commit's (``resilience.manifest.commit_tag``); each
    array passes the chaos plan's ``shard`` fault point."""
    from ..resilience.chaos import fault_point

    os.makedirs(os.path.join(directory, "arrays"), exist_ok=True)
    writer = file_writer or RetryingWriter().write_array
    meta = []
    for i, (key, leaf) in enumerate(flatten_with_paths(tree)):
        arr, dtype_name, raw_view = leaf_to_numpy(leaf)
        writer(os.path.join(directory, "arrays", f"{i}.npy"), arr)
        fault_point("shard", index=i)
        meta.append({"key": key, "index": i, "shape": [int(n) for n in arr.shape],
                     "dtype": dtype_name, "raw_view": raw_view})
    RetryingWriter().write_bytes(
        os.path.join(directory, "state.msgpack"),
        msgpack_codec.packb({"leaves": meta, "format_version": 1}), fsync=False)


def read_meta(directory: str) -> dict:
    """The parsed ``state.msgpack`` of a tree directory, its version checked."""
    with open(os.path.join(directory, "state.msgpack"), "rb") as f:
        meta = msgpack_codec.unpackb(f.read())
    version = meta.get("format_version") if isinstance(meta, dict) else None
    if version not in KNOWN_FORMAT_VERSIONS:
        raise ValueError(
            f"checkpoint {directory} has format_version {version!r}; this build reads "
            f"{list(KNOWN_FORMAT_VERSIONS)}: it was written by an incompatible (likely newer) "
            "writer, or the file is not a checkpoint state file")
    return meta


def _stored_tensor(directory: str, m: dict) -> torch.Tensor:
    arr = np.load(os.path.join(directory, "arrays", f"{m['index']}.npy"))
    if m.get("raw_view"):
        if m["dtype"] != "bfloat16":
            raise ValueError(f"leaf {m['key']!r}: stored dtype {m['dtype']!r} has no torch "
                             "counterpart here")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_pytree(template: Any, directory: str,
                on_shape_mismatch: Optional[Callable[[str, Any, Any], Any]] = None) -> Any:
    """The tree stored under ``directory``, in the structure of
    ``template``, whose leaves give each stored leaf's shape and dtype
    (anything with ``shape`` and a torch ``dtype``: a ``meta`` tensor will
    do). Leaves come back as CPU tensors; a leaf is cast only where its
    stored dtype differs from the template's. A shape mismatch raises, or
    goes to ``on_shape_mismatch(key, stored, template_leaf)``, which returns
    the leaf to use, of the template's shape (the reshard-on-load policy,
    ``runtime/zero/reshard.py`` ``load_resolver``)."""
    by_key = {m["key"]: m for m in read_meta(directory)["leaves"]}

    def load(key, leaf):
        m = by_key.get(key)
        if m is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = _stored_tensor(directory, m)
        if t.dtype != leaf.dtype:
            t = t.to(leaf.dtype)
        if tuple(t.shape) != tuple(leaf.shape):
            if on_shape_mismatch is None:
                raise ValueError(f"shape mismatch for {key!r}: checkpoint {tuple(t.shape)} vs "
                                 f"model {tuple(leaf.shape)}")
            t = torch.as_tensor(np.asarray(on_shape_mismatch(key, t, leaf))).to(leaf.dtype)
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"shape-mismatch resolver for {key!r} returned shape "
                                 f"{tuple(t.shape)}, expected {tuple(leaf.shape)}")
        return t

    return map_with_paths(load, template)


__all__ = ["save_pytree", "load_pytree", "read_meta", "flatten_with_paths", "map_with_paths",
           "leaf_to_numpy", "KNOWN_FORMAT_VERSIONS"]
