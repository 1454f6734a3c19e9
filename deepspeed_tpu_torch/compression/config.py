"""The ``compression_training`` block (counterpart of
``deepspeed_tpu/compression/config.py``, device-free, kept as its own copy):
weight quantization (MoQ), activation quantization, sparse / row / head /
channel pruning and layer reduction, normalized into one defaulted dict
with the reference's keys.
"""

from __future__ import annotations

from typing import Any, Dict


def _shared(block: Dict[str, Any], defaults: Dict[str, Any]) -> Dict[str, Any]:
    shared = dict(defaults)
    shared.update(block.get("shared_parameters", {}))
    return shared


def get_compression_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Normalize a ``compression_training`` dict (missing pieces -> disabled)."""
    cfg = cfg or {}
    out: Dict[str, Any] = {}

    wq = cfg.get("weight_quantization", {})
    out["weight_quantization"] = {
        "shared": _shared(wq, {
            "enabled": False,
            "quantizer_kernel": False,
            "schedule_offset": 0,
            "quantize_groups": 1,
            "quantize_verbose": False,
            "quantization_type": "symmetric",
            "quantize_weight_in_forward": True,
            "rounding": "nearest",
            "fp16_mixed_quantize": False,
        }),
        "groups": wq.get("different_groups", {}),
    }

    aq = cfg.get("activation_quantization", {})
    out["activation_quantization"] = {
        "shared": _shared(aq, {
            "enabled": False,
            "quantization_type": "symmetric",
            "range_calibration": "dynamic",
            "schedule_offset": 0,
        }),
        "groups": aq.get("different_groups", {}),
    }

    for name in ("sparse_pruning", "row_pruning", "head_pruning", "channel_pruning"):
        blk = cfg.get(name, {})
        out[name] = {
            "shared": _shared(blk, {
                "enabled": False,
                "method": "l1",
                "schedule_offset": 0,
            }),
            "groups": blk.get("different_groups", {}),
        }

    lr = cfg.get("layer_reduction", {})
    out["layer_reduction"] = {
        "enabled": lr.get("enabled", False),
        "keep_number_layer": lr.get("keep_number_layer"),
        "teacher_layer": lr.get("teacher_layer", []),
        "module_name_prefix": lr.get("module_name_prefix", ""),
        "other_module_name": lr.get("other_module_name", []),
    }
    return out
