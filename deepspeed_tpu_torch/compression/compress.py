"""Compression in training: QAT weight quantization (MoQ) with annealed
bits, pruning masks, layer reduction and post-training weight quantization
(counterpart of ``deepspeed_tpu/compression/compress.py``).

As in the reference, compression is a transform of the parameter tree that
the engine applies inside the loss, so the straight-through fake-quant
gradient reaches the unquantized (master) weights. The reference gates each
piece with ``lax.cond`` on the traced step; here the step is a host integer
and each gate is a host ``if``, so nothing sorts ``|W|`` before its offset.
Under a curvature vector (the eigenvalue probe's, ``runtime/eigenvalue.py``)
the stacked per-layer leaves quantize on a per-layer stretched schedule, the
gate a ``torch.where`` over the leading (layer) axis.

Leaves are picked by their key paths (``blocks/attn_qkv_w``): matmul weights
(two or more dimensions, not biases), never a path containing one of
:data:`_EXCLUDE_DEFAULT`; ``different_groups`` match paths by substring or
``fnmatch`` pattern. ``activation_quantization`` raises, as the reference
does: activations are out of reach of a parameter transform.
"""

from __future__ import annotations

import fnmatch
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint.serialization import flatten_with_paths, map_with_paths
from ..ops.quantizer import annealed_bits, dequantize, fake_quant, fake_quant_dynamic, quantize
from ..utils.logging import log_dist
from .config import get_compression_config

# params whose key path contains one of these are never quantized or pruned
_EXCLUDE_DEFAULT = ("ln", "layernorm", "norm", "bias", "wpe", "wte", "embed")


def _is_weight(key: str, leaf) -> bool:
    """Matmul weights only: stacked per-layer biases are 2-D ([L, F]) but
    stay biases."""
    if not hasattr(leaf, "dim") or leaf.dim() < 2:
        return False
    last = key.rsplit("/", 1)[-1].lower()
    return not (last.endswith("_b") or "bias" in last)


def _matches(key: str, patterns: List[str]) -> bool:
    k = key.lower()
    return any(p.lower() in k or fnmatch.fnmatch(k, p.lower()) for p in patterns)


class CompressionScheduler:
    """Per-leaf compression plan applied inside the training step."""

    def __init__(self, config: Dict[str, Any], param_tree):
        self.cfg = get_compression_config(config)
        self.plan: Dict[str, Dict[str, Any]] = {}
        wq = self.cfg["weight_quantization"]
        sp = self.cfg["sparse_pruning"]
        for key, leaf in flatten_with_paths(param_tree):
            if not _is_weight(key, leaf) or _matches(key, list(_EXCLUDE_DEFAULT)):
                continue
            entry: Dict[str, Any] = {}
            if wq["shared"]["enabled"]:
                gp = self._group_params(key, wq["groups"])
                entry["quant_bits"] = int(gp.get("start_bits", 8))
                entry["quant_groups"] = int(gp.get(
                    "quantize_groups", wq["shared"]["quantize_groups"]))
                entry["quant_offset"] = int(wq["shared"]["schedule_offset"])
                # progressive MoQ: bits anneal start -> target over doubling periods
                entry["quant_target_bits"] = int(gp.get("target_bits", entry["quant_bits"]))
                entry["quant_period"] = int(gp.get("quantization_period", 1000))
            if sp["shared"]["enabled"]:
                ratio, _ = self._group_lookup(key, sp["groups"], ("dense_ratio", 0.5),
                                              ("unused", 0))
                entry["prune_ratio"] = float(ratio)
                entry["prune_offset"] = int(sp["shared"]["schedule_offset"])
                entry["prune_method"] = sp["shared"]["method"]
            rp = self.cfg["row_pruning"]
            if rp["shared"]["enabled"] and leaf.dim() >= 2:
                ratio, _ = self._group_lookup(key, rp["groups"], ("dense_ratio", 0.5),
                                              ("unused", 0))
                entry["row_ratio"] = float(ratio)
                entry["row_offset"] = int(rp["shared"]["schedule_offset"])
            hp = self.cfg["head_pruning"]
            if hp["shared"]["enabled"] and "attn_out" in key.lower():
                gp = self._group_params(key, hp["groups"])
                heads = gp.get("num_heads", hp["shared"].get("num_heads"))
                if heads is None:
                    raise ValueError("head_pruning requires num_heads (shared_parameters "
                                     "or the matching group's params)")
                ratio, _ = self._group_lookup(key, hp["groups"], ("dense_ratio", 0.5),
                                              ("unused", 0))
                entry["head_ratio"] = float(ratio)
                entry["head_offset"] = int(hp["shared"]["schedule_offset"])
                entry["num_heads"] = int(heads)
            cp = self.cfg["channel_pruning"]
            if cp["shared"]["enabled"] and leaf.dim() >= 4:
                ratio, _ = self._group_lookup(key, cp["groups"], ("dense_ratio", 0.5),
                                              ("unused", 0))
                entry["chan_ratio"] = float(ratio)
                entry["chan_offset"] = int(cp["shared"]["schedule_offset"])
            if entry:
                self.plan[key] = entry
        if self.cfg["activation_quantization"]["shared"]["enabled"]:
            raise NotImplementedError(
                "activation_quantization is not supported: this framework applies "
                "compression as a parameter-tree transform inside the loss; quantizing "
                "activations requires model support")
        if self.plan:
            log_dist(f"compression: {len(self.plan)} tensors under "
                     f"{'QAT ' if wq['shared']['enabled'] else ''}"
                     f"{'pruning' if sp['shared']['enabled'] else ''}".strip())
        # the key-path prefix of the stacked layer subtree ([n_layer, ...]
        # leaves); the engine sets it to the eigenvalue probe's subtree
        self.curvature_scope = "blocks"

    @staticmethod
    def _group_lookup(key: str, groups: Dict[str, Any], first: Tuple[str, Any],
                      second: Tuple[str, Any]):
        """``different_groups`` entries: {name: {params: {...}, modules: [patterns]}}."""
        for _, g in (groups or {}).items():
            if _matches(key, g.get("modules", ["*"])):
                p = g.get("params", {})
                return p.get(first[0], first[1]), p.get(second[0], second[1])
        return first[1], second[1]

    @staticmethod
    def _group_params(key: str, groups: Dict[str, Any]) -> Dict[str, Any]:
        """The params dict of the first matching ``different_groups`` entry."""
        for _, g in (groups or {}).items():
            if _matches(key, g.get("modules", ["*"])):
                return g.get("params", {})
        return {}

    @property
    def enabled(self) -> bool:
        return bool(self.plan)

    # ------------------------------------------------------------------ in-step
    def transform(self, params, step: int, curvature=None):
        """Scheduled fake-quant and pruning of the planned leaves at the host
        step ``step``. ``curvature``: an optional ``[n_layer]`` host array (or
        tensor) of normalized per-layer eigenvalues in ``[0, 1]``; stacked
        leaves of the curvature scope then quantize from ``offset x (1 +
        floor(ev x 4))`` on, with the drop periods stretched by the same
        factor, so that high-curvature layers quantize later."""
        if not self.plan:
            return params
        step = int(step)
        if curvature is not None:
            curvature = np.asarray(curvature.detach().cpu() if torch.is_tensor(curvature)
                                   else curvature, np.float32)

        def leaf(key, x):
            entry = self.plan.get(key)
            if entry is None:
                return x
            # masks apply to the raw weights, then fake-quant (the reference's
            # LinearLayer_Compress order)
            if "prune_ratio" in entry and step >= entry["prune_offset"]:
                x = _prune_l1(x, entry["prune_ratio"])
            if "row_ratio" in entry and step >= entry["row_offset"]:
                x = _prune_rows(x, entry["row_ratio"])
            if "head_ratio" in entry and step >= entry["head_offset"]:
                x = _prune_heads(x, entry["head_ratio"], entry["num_heads"])
            if "chan_ratio" in entry and step >= entry["chan_offset"]:
                x = _prune_rows(x, entry["chan_ratio"])
            if "quant_bits" in entry:
                x = self._quantize(key, x, entry, step, curvature)
            return x

        return map_with_paths(leaf, params)

    def _quantize(self, key, x, entry, step, curvature):
        offset, start_b = entry["quant_offset"], entry["quant_bits"]
        target_b = entry.get("quant_target_bits", start_b)
        per_layer = (curvature is not None and key.startswith(self.curvature_scope + "/")
                     and x.dim() >= 1 and x.shape[0] == curvature.shape[0])
        factor = (np.float32(1.0) + np.floor(curvature * np.float32(4.0)) if per_layer
                  else np.float32(1.0))
        onset = (np.float32(offset) * factor).astype(np.float32)
        gate = step >= onset.astype(np.int64)
        if not np.any(gate):
            return x
        if target_b < start_b:
            # the eigenvalue factor stretches both the onset and the drop periods
            bits = annealed_bits(step - onset, start_b, target_b, entry["quant_period"], factor)
            xq = fake_quant_dynamic(x, bits if per_layer else float(bits),
                                    entry["quant_groups"])
        else:
            xq = fake_quant(x, start_b, entry["quant_groups"])
        if np.all(gate):
            return xq
        mask = torch.from_numpy(gate).to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(mask, xq, x)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _prune_l1(x: torch.Tensor, dense_ratio: float) -> torch.Tensor:
    """Magnitude (L1) pruning to ``dense_ratio`` density: the smallest-|x|
    entries zeroed (ties at the threshold kept)."""
    k = max(1, int(round(x.numel() * dense_ratio)))
    mag = x.detach().abs()
    threshold = torch.sort(mag.reshape(-1)).values[x.numel() - k]
    return torch.where(mag >= threshold, x, _zero(x))


def _prune_rows(x: torch.Tensor, dense_ratio: float) -> torch.Tensor:
    """Structured pruning of whole output units (the last dimension) below
    the top ``dense_ratio`` by L2 norm (and of conv output channels, whose
    kernels are ``[..., cout]``)."""
    norms = torch.sqrt((x.detach().float() ** 2).sum(dim=tuple(range(x.dim() - 1))))
    n = norms.shape[0]
    k = max(1, int(round(n * dense_ratio)))
    thr = torch.sort(norms).values[n - k]
    return torch.where(norms >= thr, x, _zero(x))


def _prune_heads(x: torch.Tensor, dense_ratio: float, num_heads: int) -> torch.Tensor:
    """Structured pruning of whole attention heads: the output projection's
    input dimension (-2) as ``[num_heads, head_dim]``, the lowest-norm heads
    of each layer zeroed."""
    d_in = x.shape[-2]
    if d_in % num_heads:
        raise ValueError(f"head_pruning: dim {d_in} not divisible by {num_heads} heads")
    xh = x.reshape(x.shape[:-2] + (num_heads, d_in // num_heads, x.shape[-1]))
    norms = torch.sqrt((xh.detach().float() ** 2).sum(dim=(-2, -1)))
    k = max(1, int(round(num_heads * dense_ratio)))
    thr = torch.sort(norms, dim=-1).values[..., num_heads - k]
    mask = (norms >= thr[..., None]).to(x.dtype)
    return (xh * mask[..., None, None]).reshape(x.shape)


def init_compression(param_tree, ds_config) -> CompressionScheduler:
    """A scheduler from a ``DeepSpeedConfig`` (or the raw block)."""
    block = (ds_config.compression_training
             if hasattr(ds_config, "compression_training") else ds_config)
    return CompressionScheduler(block, param_tree)


def redundancy_clean(params, ds_config, step: Optional[int] = None):
    """The terminal compression transform baked into the weights for
    deployment: fake-quant at the annealed bits and every pruning mask
    applied, as a new tree (no gradient). ``step`` defaults to far past
    every schedule."""
    if isinstance(ds_config, dict):
        cfg = ds_config.get("compression_training", ds_config)
    else:  # a DeepSpeedConfig (engine.config)
        cfg = getattr(ds_config, "compression_training", None) or {}
    sched = CompressionScheduler(cfg, params)
    if not sched.enabled:
        return params
    with torch.no_grad():
        return sched.transform(params, step if step is not None else 2 ** 30)


def layer_reduction_map(n_teacher_layers: int, keep: int,
                        teacher_layer: Optional[List[int]] = None) -> List[int]:
    """Which teacher layers a reduced student keeps."""
    if teacher_layer:
        assert len(teacher_layer) == keep
        return list(teacher_layer)
    if keep <= 1:
        return [n_teacher_layers - 1]
    stride = (n_teacher_layers - 1) / (keep - 1)
    return [int(round(i * stride)) for i in range(keep)]


def quantize_params_for_inference(params, bits: int = 8, num_groups: int = 1,
                                  group_size: Optional[int] = None,
                                  exclude=_EXCLUDE_DEFAULT):
    """Post-training weight quantization: (the int8 tree, the scales of each
    leaf in the tree's flatten order, None for leaves left whole, and
    ``{"quantized": keys, "dequantize": fn(dtype)}``)."""
    qs: Dict[str, Tuple[torch.Tensor, Optional[torch.Tensor]]] = {}
    for key, x in flatten_with_paths(params):
        if _is_weight(key, x) and not _matches(key, list(exclude)):
            ng = num_groups
            if group_size and x.numel() % group_size == 0:
                ng = x.numel() // group_size
            qs[key] = quantize(x, bits=bits, num_groups=ng)
        else:
            qs[key] = (x, None)
    qtree = map_with_paths(lambda key, _: qs[key][0], params)

    def dequantize_tree(dtype=torch.bfloat16):
        return map_with_paths(lambda key, _: qs[key][0] if qs[key][1] is None
                          else dequantize(*qs[key], dtype=dtype), params)

    return qtree, [s for _, s in qs.values()], {
        "quantized": [k for k, (_, s) in qs.items() if s is not None],
        "dequantize": dequantize_tree}
