"""Consolidate a checkpoint into one fp32 state dict (counterpart of
``deepspeed_tpu/utils/zero_to_fp32.py``).

Every tag carries a copy of this file, and the copy runs with the Python
standard library and numpy alone: no torch, no framework, no msgpack (the
reader of ``state.msgpack`` is :func:`unpack_msgpack` below, which the
port's ``checkpoint.msgpack_codec`` uses too). Each leaf is stored whole,
so consolidation is extraction: the fp32 master copy where there is one,
else the parameters widened to fp32 (bf16 leaves are stored as the uint16
view of their bits). Under ZeRO-Offload the masters live in the tag's host
state (the ``host_state/`` shards with ``host_meta.json``, or the
consolidated ``host_optimizer.npz``), ``master_<i>`` in the order of the
parameter leaves; a ZeRO-Infinity parameter-stream tag has no device
parameters at all, and its masters are keyed ``unit/name`` from the meta.

CLI:  python zero_to_fp32.py <checkpoint_dir> <output.npz>
where <checkpoint_dir> is a run directory (its ``latest`` tag is read) or
a tag directory.
"""

from __future__ import annotations

import json
import os
import struct
import sys
from typing import Any, Dict, Optional, Tuple

import numpy as np

# msgpack type byte -> (struct format of the value or length, kind)
_FIXED = {0xCA: (">f", "value"), 0xCB: (">d", "value"),
          0xCC: (">B", "value"), 0xCD: (">H", "value"), 0xCE: (">I", "value"),
          0xCF: (">Q", "value"), 0xD0: (">b", "value"), 0xD1: (">h", "value"),
          0xD2: (">i", "value"), 0xD3: (">q", "value"),
          0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"),
          0xDE: (">H", "map"), 0xDF: (">I", "map")}
_CONST = {0xC0: None, 0xC2: False, 0xC3: True}


def unpack_msgpack(buf: bytes, pos: int) -> Tuple[Any, int]:
    """(object, end position) of the msgpack value at ``buf[pos:]``, for the
    subset a checkpoint uses: maps, arrays, str, bool, nil, ints, floats."""
    b = buf[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if b in _CONST:
        return _CONST[b], pos
    if 0xA0 <= b < 0xC0:
        kind, n = "str", b & 0x1F
    elif 0x90 <= b < 0xA0:
        kind, n = "array", b & 0x0F
    elif 0x80 <= b < 0x90:
        kind, n = "map", b & 0x0F
    elif b in _FIXED:
        fmt, kind = _FIXED[b]
        (n,) = struct.unpack_from(fmt, buf, pos)
        pos += struct.calcsize(fmt)
        if kind == "value":
            return n, pos
    else:
        raise ValueError(f"msgpack type byte 0x{b:02x} is outside the checkpoint subset")
    if kind == "str":
        if pos + n > len(buf):
            raise ValueError("msgpack data truncated")
        return buf[pos:pos + n].decode("utf-8"), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            item, pos = unpack_msgpack(buf, pos)
            items.append(item)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = unpack_msgpack(buf, pos)
        out[k], pos = unpack_msgpack(buf, pos)
    return out, pos


def _load_leaves(state_dir: str) -> Dict[str, np.ndarray]:
    """Every leaf of a ``state/`` directory by key, bf16 widened to fp32."""
    with open(os.path.join(state_dir, "state.msgpack"), "rb") as f:
        meta, _ = unpack_msgpack(f.read(), 0)
    out = {}
    for m in meta["leaves"]:
        arr = np.load(os.path.join(state_dir, "arrays", f"{m['index']}.npy"))
        if m.get("raw_view"):
            if m["dtype"] != "bfloat16":
                raise ValueError(f"leaf {m['key']!r}: stored dtype {m['dtype']!r} is not read")
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[m["key"]] = arr
    return out


def _resolve_tag_dir(path: str) -> str:
    if os.path.exists(os.path.join(path, "state")):
        return path
    latest = os.path.join(path, "latest")
    if os.path.exists(latest):
        with open(latest) as f:
            return os.path.join(path, f.read().strip())
    raise FileNotFoundError(f"{path} is neither a tag dir nor has a 'latest' file")


def _load_host_masters(ckpt: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """(the flat host state, the shard meta) of a tag's offload state, or
    ({}, {}) where it has none."""
    host_dir = os.path.join(ckpt, "host_state")
    meta_path = os.path.join(host_dir, "host_meta.json")
    if os.path.isdir(host_dir) and os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        out: Dict[str, np.ndarray] = {}
        for shard in meta.get("shards", []):
            with np.load(os.path.join(host_dir, shard["file"])) as d:
                for key in d.files:
                    out[key] = d[key]
        return out, meta
    host_path = os.path.join(ckpt, "host_optimizer.npz")
    if os.path.exists(host_path):
        with np.load(host_path) as d:
            return {k: d[k] for k in d.files}, {}
    return {}, {}


def get_fp32_state_dict_from_zero_checkpoint(
        checkpoint_dir: str, tag: Optional[str] = None) -> Dict[str, np.ndarray]:
    """{param key: fp32 array} of a tag: its master copy, else its params."""
    ckpt = os.path.join(checkpoint_dir, tag) if tag is not None else _resolve_tag_dir(
        checkpoint_dir)
    leaves = _load_leaves(os.path.join(ckpt, "state"))
    masters = {k[len("master/"):]: v for k, v in leaves.items() if k.startswith("master/")}
    params = {k[len("params/"):]: v for k, v in leaves.items() if k.startswith("params/")}
    host, host_meta = ({}, {}) if masters else _load_host_masters(ckpt)
    if not masters and host:
        if not params and host_meta.get("leaves"):
            # a parameter-stream tag: the weights exist only as host masters
            return {f"{lf['unit']}/{lf['name']}": np.asarray(host[f"master_{lf['i']}"],
                                                              np.float32)
                    for lf in host_meta["leaves"]}
        for i, key in enumerate(params):  # the params' leaf order
            if f"master_{i}" in host:
                masters[key] = host[f"master_{i}"].reshape(params[key].shape)
    out = {}
    for key, arr in params.items():
        src = masters.get(key, arr)
        out[key] = src if src.dtype == np.float32 else np.asarray(src, np.float32)
    if not out:
        raise ValueError(f"no params found in {ckpt}")
    return out


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir: str, output_file: str,
                                               tag: Optional[str] = None) -> None:
    """Write the consolidated fp32 state dict to ``output_file`` (``.npz``)."""
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    np.savez(output_file, **sd)
    total = sum(int(v.size) for v in sd.values())
    print(f"saved {len(sd)} tensors ({total / 1e6:.1f}M params, fp32) to {output_file}")


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__)
        return 1
    convert_zero_checkpoint_to_fp32_state_dict(argv[0], argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
