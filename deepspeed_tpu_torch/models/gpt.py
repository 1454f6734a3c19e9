"""GPT-family decoder-only language models (counterpart of
``deepspeed_tpu/models/gpt.py``).

The functional API of the reference is kept, ``f(cfg, params, ...)`` with
``params`` a dict of tensors, so that parity tests compare like with like:

- per-layer weights are stacked on a leading ``L`` axis under
  ``params["blocks"]`` and the layers run as a Python loop over that axis
  (the reference's ``lax.scan``);
- projections keep the reference's ``x @ W`` layout (``qkv_w`` is
  ``[L, d, 3d]``, not ``nn.Linear``'s ``[out, in]``), so a JAX parameter tree
  crosses over through :mod:`deepspeed_tpu_torch.bridge` unchanged;
- attention goes through ``ops.attention.multihead_attention`` (the flash
  kernels on CUDA when eligible, differentiable through the B1 forward and
  B2 backward) or, with ``GPTConfig.sparse_attention``, through
  ``ops.sparse_attention`` and the blocksparse kernels (B9, forward and
  backward), the cached decode step through the decode-attention kernel
  and the paged decode step (:func:`paged_decode_step`, over dense, int8 or
  int4 page pools) through the paged one;
- a projection weight is dense (``torch.matmul``) or a quantized leaf,
  ``{"q", "s"}`` (int8) or ``{"q4", "s"}`` (nibble-packed int4) with fp32
  group scales [L, groups per layer] (:func:`quantize_for_inference`,
  :func:`init_quantized_decode_params`); :func:`_wm` sends those to the
  int8 / int4 weight kernels. The cached paths (:func:`forward_with_cache`,
  :func:`paged_decode_step`) take either; the scoring :func:`forward` takes
  dense weights, as the reference's does;
- under a bound ZeRO stage-3 config (``runtime/zero/gather.py``
  ``gather_window``) the layer loop gathers each layer's parameters just
  before it runs (:func:`~..runtime.zero.gather.zero3_layers`), over the
  int8/int4 wire with ``zero_quantized_weights``; with
  ``zero_quantized_head`` as well, the LM head runs through
  ``comm.quantized.quantized_matmul_reshard`` and kernel B8, exactly where
  the reference's ``_head_quantization`` gate opens;
- the training-mode forward has dropout and stochastic depth drawn from
  explicit per-(step, layer, salt) seeds, and activation checkpointing
  (``remat``) through ``torch.utils.checkpoint``, which recomputes each
  block with the same seeds and so the same masks;
- ALiBi (``alibi``) and GPT-Neo's alternating local window
  (``local_attention_period``) are additive biases on the attention
  logits, so those layers take the plain attention path, in the cached
  decode step too: the flash and decode kernels take no bias, as in the
  reference; the paged paths refuse them with the reference's
  ``ValueError``;
- ``loss_chunk`` evaluates the LM head and the cross entropy over
  sequence slices (:class:`_ChunkedCE`): the fp32 ``[B, T, V]`` logits
  exist neither in the forward nor in the backward.

:func:`build` makes the trainable :class:`~.api.Module` the engine takes;
:class:`GPTModel` is a thin frozen ``nn.Module`` for inference. Options this
slice does not port raise ``NotImplementedError`` naming the ``ROADMAP.md``
item that will port them (:func:`check_config`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..accelerator import resolve_device, to_device
from ..comm.quantized import QuantizedCommConfig, quantized_matmul_reshard
from ..ops.attention import multihead_attention
from ..ops.cuda.decode_attention import (decode_attention, paged_decode_attention,
                                         paged_verify_attention, unpack_kv_int4)
from ..ops.cuda.flash_attention import NEG_INF
from ..ops.cuda.int8_matmul import int4_matmul, int8_matmul, pack_int4, unpack_int4
from ..ops.quantizer import dequantize, quantize
from ..ops.sparse_attention import sparse_attention
from ..runtime.zero.gather import _active_cfg, _quantization, zero3_layers
from ..utils.errors import unported
from ..utils.rng import fold_in
from .api import Module

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: Optional[int] = None  # default 4*d_model
    max_seq_len: int = 1024
    rotary: bool = False  # False: learned positions (GPT-2); True: RoPE (NeoX)
    rotary_pct: float = 1.0
    tie_embeddings: bool = True
    dropout: float = 0.0  # residual-branch dropout, training only
    layer_norm_eps: float = 1e-5
    activation: str = "gelu"  # "gelu" (tanh approx), "gelu_exact", "relu", "quick_gelu"
    parallel_residual: bool = False  # NeoX-style x + attn(ln1 x) + mlp(ln2 x)
    pos_offset: int = 0  # learned-position index offset (OPT uses 2)
    alibi: bool = False  # Bloom: linear attention bias instead of positions
    rotary_interleaved: bool = False  # GPT-J rotate_every_two vs NeoX rotate_half
    embed_layernorm: bool = False  # Bloom: LN right after the token embedding
    lm_head_bias: bool = False  # GPT-J: bias on the (untied) LM head
    remat: bool = False  # activation checkpointing per block (torch.utils.checkpoint)
    remat_policy: str = "nothing_saveable"  # the only policy ported (others: A3b)
    use_flash: Optional[bool] = None  # None = auto dispatch (the kernels on CUDA)
    # the reference's Pallas tile sizes; the CUDA kernels fix their own tiles
    # (64 rows), and the tile size does not change the result
    flash_block_q: int = 256
    flash_block_k: int = 256
    stochastic_mode: bool = False  # flash attention's single-cast function (16-bit inputs)
    stochastic_depth: float = 0.0  # whole-block drop probability, training only
    # GPT-Neo-style alternating local attention: the last layer of each
    # period attends only to the trailing ``window_size`` positions
    local_attention_period: int = 0  # 0 = all layers global
    window_size: int = 256
    attention_scale: Optional[float] = None  # None = 1/sqrt(head_dim)
    has_lm_head: bool = True  # False: pure encoder, only return_hidden=True is valid
    # a SparsityConfig (ops.sparse_attention) routes every layer's attention
    # in forward / loss_fn / training through the blocksparse kernels (B9),
    # whatever use_flash says; the cached and paged paths attend densely, as
    # the reference's do
    sparse_attention: Optional[Any] = None
    random_ltd_layer_ids: Tuple[int, ...] = ()  # random-LTD, not ported (A3b)
    random_ltd_keep: Optional[int] = None
    seq_parallel_impl: str = "dense"  # "ring" / "ulysses" not ported (A13)
    # chunked cross-entropy: the LM head and the loss over ``loss_chunk``-token
    # slices, so the fp32 [B, T, V] logits never exist. 0 = whole sequence
    loss_chunk: int = 0

    @property
    def ffn_dim(self) -> int:
        return self.d_ff if self.d_ff is not None else 4 * self.d_model

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_head:
            raise ValueError(f"d_model {self.d_model} is not divisible by n_head {self.n_head}")
        return self.d_model // self.n_head

    def num_params(self) -> int:
        d, f, v, l = self.d_model, self.ffn_dim, self.vocab_size, self.n_layer
        per_layer = 4 * d * d + 2 * d * f + 13 * d  # qkv+out + mlp + ln/bias
        emb = v * d + (0 if self.rotary else self.max_seq_len * d)
        return l * per_layer + emb + 2 * d


# Named presets (sizes follow the GPT-2 / GPT-NeoX families), as in the reference.
PRESETS: Dict[str, GPTConfig] = {
    "gpt2-125m": GPTConfig(n_layer=12, n_head=12, d_model=768),
    "gpt2-350m": GPTConfig(n_layer=24, n_head=16, d_model=1024),
    "gpt2-760m": GPTConfig(n_layer=24, n_head=16, d_model=1536),
    "gpt2-1.3b": GPTConfig(n_layer=24, n_head=32, d_model=2048),
    "gpt-neox-1.3b": GPTConfig(n_layer=24, n_head=16, d_model=2048, rotary=True, rotary_pct=0.25),
    "gpt-neox-6.7b": GPTConfig(n_layer=32, n_head=32, d_model=4096, rotary=True, rotary_pct=0.25),
    "gpt-neox-20b": GPTConfig(
        vocab_size=50432, n_layer=44, n_head=64, d_model=6144, max_seq_len=2048,
        rotary=True, rotary_pct=0.25),
    "bloom-7b1": GPTConfig(
        vocab_size=250880, n_layer=30, n_head=32, d_model=4096,
        max_seq_len=2048, alibi=True, embed_layernorm=True,
        tie_embeddings=True),
    "opt-13b": GPTConfig(
        vocab_size=50272, n_layer=40, n_head=40, d_model=5120,
        max_seq_len=2048, rotary=False, pos_offset=2, activation="relu",
        tie_embeddings=True),
    "tiny": GPTConfig(vocab_size=256, n_layer=2, n_head=4, d_model=64, max_seq_len=128),
}


def check_config(cfg: GPTConfig) -> None:
    """Raise for a config option whose semantics this slice does not port."""
    if cfg.seq_parallel_impl != "dense":
        raise unported(f"seq_parallel_impl={cfg.seq_parallel_impl!r} "
                       "(sequence-parallel attention)", "A13")


def _check_train(cfg: GPTConfig, train: bool, pld_theta, seq_len: int) -> None:
    if pld_theta is not None:
        raise unported("progressive layer drop (pld_theta)", "A3b")
    if (train and cfg.random_ltd_keep is not None and cfg.random_ltd_keep < seq_len
            and cfg.random_ltd_layer_ids):
        raise unported("random-LTD (random_ltd_keep / random_ltd_layer_ids)", "A3b")
    if cfg.remat and cfg.remat_policy != "nothing_saveable":
        raise unported(f"remat_policy={cfg.remat_policy!r} (only nothing_saveable "
                       "is ported)", "A3b")


# --------------------------------------------------------------------------- init
def init_params(cfg: GPTConfig, rng: Union[int, torch.Generator] = 0,
                device=None, total_depth: Optional[int] = None) -> Params:
    """fp32 parameters with the reference's leaf names and stacked shapes,
    drawn from ``rng`` (a ``torch.Generator``, or a seed for a new CPU one)
    and placed on ``device`` (default: the CUDA device)."""
    dev = resolve_device(device)
    gen = rng if isinstance(rng, torch.Generator) else torch.Generator().manual_seed(int(rng))
    d, f, v, l = cfg.d_model, cfg.ffn_dim, cfg.vocab_size, cfg.n_layer
    std = 0.02
    # residual-out projections scaled by 1/sqrt(2L) (GPT-2 init); total_depth
    # overrides L when this stack is a slice of a deeper model
    res_std = std / math.sqrt(2.0 * (total_depth or l))

    def normal(shape, s):
        return (torch.randn(shape, generator=gen, device=gen.device) * s).to(dev)

    def ones(*shape):
        return torch.ones(shape, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    params: Params = {
        "wte": normal((v, d), std),
        "blocks": {
            "ln1_scale": ones(l, d), "ln1_bias": zeros(l, d),
            "qkv_w": normal((l, d, 3 * d), std), "qkv_b": zeros(l, 3 * d),
            "attn_out_w": normal((l, d, d), res_std), "attn_out_b": zeros(l, d),
            "ln2_scale": ones(l, d), "ln2_bias": zeros(l, d),
            "mlp_up_w": normal((l, d, f), std), "mlp_up_b": zeros(l, f),
            "mlp_down_w": normal((l, f, d), res_std), "mlp_down_b": zeros(l, d),
        },
        "lnf_scale": ones(d),
        "lnf_bias": zeros(d),
    }
    if not cfg.rotary and not cfg.alibi:
        params["wpe"] = normal((cfg.max_seq_len + cfg.pos_offset, d), std)
    if cfg.embed_layernorm:
        params["emb_ln_scale"] = ones(d)
        params["emb_ln_bias"] = zeros(d)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((v, d), std)
        if cfg.lm_head_bias:
            params["lm_head_b"] = zeros(v)
    return params


# --------------------------------------------------------------------------- layers
def layer_norm(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    # fp32 statistics regardless of the compute dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, rotary_dims: int,
          interleaved: bool = False) -> torch.Tensor:
    """Rotary embedding on the first ``rotary_dims`` of the head dim. x: [B,T,H,Dh].

    ``interleaved=False``: NeoX rotate_half (pair (i, i+half)).
    ``interleaved=True``: GPT-J rotate_every_two (pair (2i, 2i+1))."""
    if rotary_dims == 0:
        return x
    x_rot, x_pass = x[..., :rotary_dims], x[..., rotary_dims:]
    half = rotary_dims // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(0, half, dtype=torch.float32,
                                            device=x.device) / half))
    angles = positions[:, :, None].float() * freqs[None, None, :]  # [B,T,half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    if interleaved:
        x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
        rotated = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                              dim=-1).reshape(x_rot.shape)
    else:
        x1, x2 = x_rot[..., :half], x_rot[..., half:]
        rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated, x_pass], dim=-1)


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Bloom's per-head ALiBi slopes, fp32 (non-power-of-two head counts take
    every other slope of the next power of two for the heads past the
    largest power of two below)."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(np.log2(n) - 3)))
        return start * (start ** np.arange(n))

    n = 2 ** int(np.floor(np.log2(n_heads)))
    slopes = pow2_slopes(n)
    if n < n_heads:
        extra = pow2_slopes(2 * n)[0::2][: n_heads - n]
        slopes = np.concatenate([slopes, extra])
    return slopes.astype(np.float32)


def _alibi_bias(cfg: GPTConfig, q_positions: torch.Tensor, kv_len: int) -> torch.Tensor:
    """[B, H, T, S] fp32 additive bias: slopes[h] * (s - t_abs)."""
    dev = q_positions.device
    slopes = torch.from_numpy(alibi_slopes(cfg.n_head)).to(dev)
    s_idx = torch.arange(kv_len, device=dev)[None, None, None, :]
    t_abs = q_positions[:, None, :, None]
    return slopes[None, :, None, None] * (s_idx - t_abs).float()


def _is_local_layer(cfg: GPTConfig, layer_idx: Optional[int]) -> Optional[bool]:
    """Does layer ``layer_idx`` attend over a window? GPT-Neo alternates
    [global, local]: the last layer of each period is local. None when the
    config never uses local attention."""
    if cfg.local_attention_period <= 1 or layer_idx is None:
        return None
    p = cfg.local_attention_period
    return layer_idx % p == p - 1


def _local_window_bias(cfg: GPTConfig, q_positions: torch.Tensor, kv_len: int,
                       is_local: bool) -> torch.Tensor:
    """[B, 1, T, S] fp32 additive bias masking keys at ``s <= t - window_size``
    with -1e30 on a local layer (zero on a global one, as the reference's
    uniform layer program has it)."""
    s_idx = torch.arange(kv_len, device=q_positions.device)[None, None, None, :]
    too_old = s_idx <= q_positions[:, None, :, None] - cfg.window_size
    return torch.where(too_old & is_local, NEG_INF, 0.0)


def _act(cfg: GPTConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "relu":
        return F.relu(h)
    if cfg.activation == "gelu_exact":
        return F.gelu(h)
    if cfg.activation == "quick_gelu":  # CLIP: x * sigmoid(1.702 x)
        return h * torch.sigmoid(1.702 * h)
    return F.gelu(h, approximate="tanh")


def _is_qleaf(v) -> bool:
    """A quantized weight leaf: int8 ``{"q", "s"}`` or packed int4 ``{"q4", "s"}``."""
    return isinstance(v, dict) and set(v.keys()) in ({"q", "s"}, {"q4", "s"})


def _wm(h: torch.Tensor, leaf) -> torch.Tensor:
    """``h @ W`` where W is dense or one layer's quantized leaf, int8
    ``{"q", "s"}`` or packed int4 ``{"q4", "s"}``: those go to the int8 / int4
    weight kernels (B6 / B7), which dequantize in registers, so no dequantized
    weight exists for a decode step. The group size is the leaf's own,
    weights per scale."""
    if not _is_qleaf(leaf):
        return h @ leaf
    shape = h.shape
    x = h.reshape(-1, shape[-1])
    s = leaf["s"].reshape(-1)
    if "q4" in leaf:
        q4 = leaf["q4"]
        out = int4_matmul(x, q4, s, group_size=2 * q4.numel() // s.numel())
        return out.reshape(*shape[:-1], 2 * q4.shape[1])
    q = leaf["q"]
    out = int8_matmul(x, q, s, group_size=q.numel() // s.numel())
    return out.reshape(*shape[:-1], q.shape[1])


def _rotary_dims(cfg: GPTConfig) -> int:
    rd = int(cfg.rotary_pct * cfg.head_dim)
    return rd - rd % 2


def _qkv(cfg: GPTConfig, x: torch.Tensor, w: Params, positions: torch.Tensor):
    """ln1 -> fused qkv projection -> q, k, v as [B, T, H, Dh] views, rotated."""
    B, T, D = x.shape
    H, Dh = cfg.n_head, cfg.head_dim
    h = layer_norm(x, w["ln1_scale"], w["ln1_bias"], cfg.layer_norm_eps)
    qkv = _wm(h, w["qkv_w"]) + w["qkv_b"]
    q, k, v = (t.reshape(B, T, H, Dh) for t in qkv.split(D, dim=-1))
    if cfg.rotary:
        rd = _rotary_dims(cfg)
        q = _rope(q, positions, rd, cfg.rotary_interleaved)
        k = _rope(k, positions, rd, cfg.rotary_interleaved)
    return q, k, v


def _attention_bias(cfg: GPTConfig, positions: torch.Tensor, kv_len: int,
                    layer_idx: Optional[int]) -> Optional[torch.Tensor]:
    """The sum of the ALiBi and local-window biases of layer ``layer_idx``
    (None when the config has neither)."""
    bias = _alibi_bias(cfg, positions, kv_len) if cfg.alibi else None
    is_local = _is_local_layer(cfg, layer_idx)
    if is_local is not None:
        lb = _local_window_bias(cfg, positions, kv_len, is_local)
        bias = lb if bias is None else bias + lb
    return bias


def _attention_delta(cfg: GPTConfig, x: torch.Tensor, w: Params,
                     positions: torch.Tensor, layer_idx: Optional[int] = None) -> torch.Tensor:
    """Attention output (pre-residual): attn_out(MHA(ln1(x))). A bias (ALiBi,
    a local window) sends the layer to the plain attention path."""
    B, T, D = x.shape
    q, k, v = _qkv(cfg, x, w, positions)
    bias = _attention_bias(cfg, positions, T, layer_idx)
    if cfg.sparse_attention is not None:
        if bias is not None:
            raise ValueError("sparse_attention cannot compose with alibi/local-window "
                             "biases (the blocksparse kernel has no bias input)")
        attn = sparse_attention(q, k, v, cfg.sparse_attention, causal=True,
                                softmax_scale=cfg.attention_scale)
    else:
        attn = multihead_attention(q, k, v, causal=True, bias=bias, use_flash=cfg.use_flash,
                                   softmax_scale=cfg.attention_scale,
                                   stochastic_mode=cfg.stochastic_mode)
    return _wm(attn.reshape(B, T, D), w["attn_out_w"]) + w["attn_out_b"]


def _mlp_delta(cfg: GPTConfig, x: torch.Tensor, w: Params) -> torch.Tensor:
    """MLP output (pre-residual): mlp(ln2(x))."""
    h = layer_norm(x, w["ln2_scale"], w["ln2_bias"], cfg.layer_norm_eps)
    h = _act(cfg, _wm(h, w["mlp_up_w"]) + w["mlp_up_b"])
    return _wm(h, w["mlp_down_w"]) + w["mlp_down_b"]


def _dropout(x: torch.Tensor, rate: float, seed: Optional[int], train: bool,
             salt: int) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``fold_in(seed, salt)``:
    the same seed gives the same mask, which is what a recompute needs."""
    if rate == 0.0 or not train or seed is None:
        return x
    gen = torch.Generator(device=x.device).manual_seed(fold_in(seed, salt))
    u = torch.rand(x.shape, generator=gen, device=x.device)
    return torch.where(u < 1.0 - rate, x / (1.0 - rate), 0.0).to(x.dtype)


def _block(cfg: GPTConfig, x: torch.Tensor, w: Params, positions: torch.Tensor,
           seed: Optional[int] = None, train: bool = False,
           layer_idx: Optional[int] = None) -> torch.Tensor:
    """One block; ``seed`` is the layer's dropout seed (None: no dropout),
    ``layer_idx`` its index (which layers are local)."""
    attn = _dropout(_attention_delta(cfg, x, w, positions, layer_idx), cfg.dropout, seed,
                    train, 0)
    if cfg.parallel_residual:
        # NeoX/GPT-J style: both sublayers read the same input
        return x + attn + _dropout(_mlp_delta(cfg, x, w), cfg.dropout, seed, train, 1)
    x = x + attn
    return x + _dropout(_mlp_delta(cfg, x, w), cfg.dropout, seed, train, 1)


def _layer(blocks: Params, i: int) -> Params:
    """Layer ``i`` of the stacked blocks (a quantized leaf indexed leaf by leaf)."""
    return {k: ({kk: vv[i] for kk, vv in v.items()} if _is_qleaf(v) else v[i])
            for k, v in blocks.items()}


def _n_layers(blocks: Params) -> int:
    leaf = blocks["qkv_w"]
    return (leaf["s"] if _is_qleaf(leaf) else leaf).shape[0]


def _embed(cfg: GPTConfig, params: Params, input_ids: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    x = F.embedding(input_ids, params["wte"])
    if not cfg.rotary and not cfg.alibi:
        x = x + F.embedding(positions + cfg.pos_offset, params["wpe"])
    if cfg.embed_layernorm:
        x = layer_norm(x, params["emb_ln_scale"], params["emb_ln_bias"], cfg.layer_norm_eps)
    # a quantized tree computes in the dtype of its dense leaves
    qkv_w = params["blocks"]["qkv_w"]
    return x.to(params["lnf_scale"].dtype if _is_qleaf(qkv_w) else qkv_w.dtype)


def _head_quantization() -> Optional[QuantizedCommConfig]:
    """The quantized-LM-head config, or None: open under a bound stage-3
    config with quantized weights and ``zero_quantized_head``, as the
    reference's gate is."""
    qc = _quantization()
    return qc if qc is not None and getattr(_active_cfg(), "zero_quantized_head", False) else None


def _head(cfg: GPTConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    head = params["wte"] if cfg.tie_embeddings else params["lm_head"]
    qh = _head_quantization()
    if qh is not None:
        # the int payload feeds the logits product (kernel B8); the head is
        # whole here, gathered at full precision with the embedding
        logits = quantized_matmul_reshard(x, head.to(x.dtype).t(), qh.bits, qh.block_size,
                                          "qmatmul[lm_head]")
    else:
        logits = x @ head.to(x.dtype).t()
    if cfg.lm_head_bias and not cfg.tie_embeddings:
        logits = logits + params["lm_head_b"].to(logits.dtype)
    return logits


def _as_ids(input_ids, params: Params) -> torch.Tensor:
    return torch.as_tensor(input_ids, device=params["wte"].device).long()


# --------------------------------------------------------------------------- forward
def forward(cfg: GPTConfig, params: Params, input_ids, rngs=None, train: bool = True,
            return_hidden: bool = False, pld_theta=None) -> torch.Tensor:
    """Return logits [B, T, V] (or the final-LN hidden states [B, T, D] with
    ``return_hidden``).

    ``rngs={"dropout": seed}`` (an int) seeds the training-mode draws: layer
    i uses ``fold_in(seed, i)``, its two dropout masks fold in salts 0 and 1
    and its stochastic-depth draw 0x5D, as the reference folds its keys.
    Without a seed (or with ``train=False``) nothing is dropped. Random-LTD
    and progressive layer drop raise (ROADMAP.md A3b)."""
    check_config(cfg)
    if _is_qleaf(params["blocks"]["qkv_w"]):
        raise TypeError("forward takes dense weights, as the reference's does; a quantized "
                        "tree runs through forward_with_cache (init_inference(...).forward "
                        "and generate) or paged_decode_step")
    input_ids = _as_ids(input_ids, params)
    B, T = input_ids.shape
    _check_train(cfg, train, pld_theta, T)
    if T > cfg.max_seq_len:
        raise ValueError(f"sequence length {T} exceeds max_seq_len {cfg.max_seq_len}")
    positions = torch.arange(T, device=input_ids.device).expand(B, T)
    x = _embed(cfg, params, input_ids, positions)
    blocks = params["blocks"]
    drop_seed = (rngs or {}).get("dropout")
    sd = cfg.stochastic_depth if train else 0.0

    def block_fn(x, w, seed, i):
        return _block(cfg, x, w, positions, seed, train, layer_idx=i)

    if cfg.remat and torch.is_grad_enabled():
        # recompute each block in the backward; the explicit seeds give the
        # recompute the masks of the first pass
        def run(x, w, seed, i):
            return checkpoint(block_fn, x, w, seed, i, use_reentrant=False)
    else:
        run = block_fn
    for i, w in zero3_layers(blocks):
        seed = fold_in(drop_seed, i) if drop_seed is not None else None
        if sd > 0.0 and seed is not None:
            # stochastic depth: drop the whole block with probability sd (a
            # host-side draw, so no device sync); a surviving delta is scaled
            # so that eval needs no correction
            u = torch.rand((), generator=torch.Generator().manual_seed(fold_in(seed, 0x5D)))
            if bool(u < 1.0 - sd):
                x = x + (run(x, w, seed, i) - x) / (1.0 - sd)
        else:
            x = run(x, w, seed, i)
    x = layer_norm(x, params["lnf_scale"], params["lnf_bias"], cfg.layer_norm_eps)
    if return_hidden:
        return x
    if not cfg.has_lm_head:
        raise ValueError("this config is a pure encoder (has_lm_head=False): call "
                         "forward(..., return_hidden=True)")
    return _head(cfg, params, x)


def next_token_loss(forward_fn, max_seq_len: int, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross-entropy with the optional "labels"/"loss_mask" keys and
    the seq-vs-seq+1 packing cases. ``forward_fn(input_ids) -> logits``."""
    input_ids = batch["input_ids"]
    labels = batch.get("labels")
    if labels is None:
        labels = input_ids[:, 1:]
        if input_ids.shape[1] > max_seq_len:
            # seq+1 token packing: slice inputs to max_seq_len (labels align 1:1)
            logits = forward_fn(input_ids[:, :-1])
        else:
            # keep the full length through attention; drop the last logit
            logits = forward_fn(input_ids)[:, :-1]
    else:
        logits = forward_fn(input_ids)
    logits32 = logits.float()
    logz = torch.logsumexp(logits32, dim=-1)
    gold = logits32.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask.float()
        if labels.shape != input_ids.shape:
            mask = mask[:, 1:]
        loss = (nll * mask).sum() / mask.sum().clamp(min=1.0)
    else:
        loss = nll.mean()
    return loss, {"num_tokens": nll.numel()}


def _chunk_logits(h_c: torch.Tensor, head: torch.Tensor,
                  head_bias: Optional[torch.Tensor]) -> torch.Tensor:
    """One chunk's LM-head logits in the compute dtype."""
    logits = h_c @ head.to(h_c.dtype).t()
    if head_bias is not None:
        logits = logits + head_bias.to(logits.dtype)
    return logits


class _ChunkedCE(torch.autograd.Function):
    """Masked next-token cross entropy over ``chunk``-token sequence slices:
    (sum of masked nll, sum of mask). The forward computes one chunk's
    logits at a time and keeps only each position's fp32 logsumexp; the
    backward computes each chunk's logits again and accumulates dh and the
    head's gradient chunk by chunk, so neither pass holds more than one
    chunk's ``[B, chunk, V]`` logits (the reference's rematerialized scan).
    The gradient is the reference's: the fp32 cotangent of a chunk's logits
    is cast to the compute dtype before the two products, and the chunks'
    head gradients are summed in the compute dtype, in place."""

    @staticmethod
    def forward(ctx, hidden, head, head_bias, targets, mask, chunk):
        B, T, _ = hidden.shape
        logz = torch.empty((B, T), dtype=torch.float32, device=hidden.device)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c0 in range(0, T, chunk):
            sl = slice(c0, c0 + chunk)
            logits32 = _chunk_logits(hidden[:, sl], head, head_bias).float()
            logz[:, sl] = torch.logsumexp(logits32, dim=-1)
            gold = logits32.gather(-1, targets[:, sl, None])[..., 0]
            total = total + ((logz[:, sl] - gold) * mask[:, sl]).sum()
            del logits32
        ctx.chunk = chunk
        ctx.save_for_backward(hidden, head, head_bias, targets, mask, logz)
        count = mask.sum()
        ctx.mark_non_differentiable(count)
        return total, count

    @staticmethod
    def backward(ctx, g_sum, _g_count):
        hidden, head, head_bias, targets, mask, logz = ctx.saved_tensors
        chunk = ctx.chunk
        need_h, need_w, need_b = ctx.needs_input_grad[:3]
        dh = torch.empty_like(hidden) if need_h else None
        dw = torch.zeros(head.shape, dtype=hidden.dtype, device=head.device) if need_w else None
        db = torch.zeros_like(head_bias) if need_b else None
        head_c = head.to(hidden.dtype)
        for c0 in range(0, hidden.shape[1], chunk):
            sl = slice(c0, c0 + chunk)
            h_c = hidden[:, sl]
            logits = _chunk_logits(h_c, head, head_bias)
            dtype = logits.dtype
            # d nll / d logits32 = softmax - onehot(target), scaled by mask * g
            # (in place: an fp32 chunk's logits become its cotangent)
            d32 = logits.float()
            del logits
            d32.sub_(logz[:, sl, None]).exp_()
            d32.scatter_add_(-1, targets[:, sl, None],
                             torch.full_like(logz[:, sl, None], -1.0))
            d32.mul_((mask[:, sl] * g_sum)[..., None])
            d = d32.to(dtype)
            del d32
            if need_h:
                dh[:, sl] = d @ head_c
            if need_w:  # in place: no [V, D] product besides the accumulator
                dw.addmm_(d.flatten(0, 1).t(), h_c.flatten(0, 1))
            if need_b:
                db += d.sum(dim=(0, 1)).to(db.dtype)
        return dh, dw.to(head.dtype) if need_w else None, db, None, None, None


def _chunked_ce(hidden: torch.Tensor, head: torch.Tensor, head_bias: Optional[torch.Tensor],
                targets: torch.Tensor, mask: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked cross entropy over ``chunk``-token sequence slices (see
    :class:`_ChunkedCE`). Returns (sum of masked nll, sum of mask)."""
    T = hidden.shape[1]
    if T % chunk:
        raise ValueError(f"loss_chunk {chunk} must divide seq len {T}")
    return _ChunkedCE.apply(hidden, head, head_bias, targets.long(), mask.float(), chunk)


def _chunk_targets(cfg: GPTConfig, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """(input_ids for the forward, targets [B, T], mask [B, T], the number of
    real targets), :func:`next_token_loss`'s label / mask / packing semantics
    on full-T tiles: in the plain shift the last position has no target, so
    it gets a dummy target 0 under mask 0 and is not counted."""
    input_ids = batch["input_ids"]
    labels = batch.get("labels")
    loss_mask = batch.get("loss_mask")
    if labels is None and input_ids.shape[1] > cfg.max_seq_len:
        # seq+1 token packing: inputs are the first max_seq_len tokens
        ids_in, shift_targets = input_ids[:, :-1], input_ids[:, 1:]
    else:
        ids_in, shift_targets = input_ids, None
    B, T = ids_in.shape
    ones = torch.ones((B, T), dtype=torch.float32, device=input_ids.device)
    if labels is not None:
        mask = loss_mask.float() if loss_mask is not None else ones
        return ids_in, labels, mask, labels.numel()
    if shift_targets is not None:
        mask = loss_mask[:, 1:].float() if loss_mask is not None else ones
        return ids_in, shift_targets, mask, shift_targets.numel()
    pad = torch.zeros((B, 1), dtype=input_ids.dtype, device=input_ids.device)
    targets = torch.cat([input_ids[:, 1:], pad], dim=1)
    mask = torch.cat([ones[:, 1:], pad.float()], dim=1)
    if loss_mask is not None:
        mask = mask * torch.cat([loss_mask[:, 1:], pad.to(loss_mask.dtype)], dim=1).float()
    return ids_in, targets, mask, targets.numel() - B  # the dummy column excluded


def chunked_head_loss(cfg: GPTConfig, params: Params, hidden: torch.Tensor,
                      targets: torch.Tensor, mask: torch.Tensor,
                      num_tokens: Optional[int] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The chunked LM head and masked cross entropy over the post-LN
    ``hidden``. The head is the dense leaf (``wte`` tied, else ``lm_head``),
    as the reference reads it, with or without ``zero_quantized_head``."""
    head = params["wte"] if cfg.tie_embeddings else params["lm_head"]
    head_b = params.get("lm_head_b") if (cfg.lm_head_bias and not cfg.tie_embeddings) else None
    s, c = _chunked_ce(hidden, head, head_b, targets, mask, cfg.loss_chunk)
    # the masked mean is next_token_loss's in every case: without a
    # loss_mask the mask counts exactly the real target positions
    return s / c.clamp(min=1.0), {
        "num_tokens": int(num_tokens if num_tokens is not None else targets.numel())}


def chunked_loss(cfg: GPTConfig, params: Params, batch: Dict[str, torch.Tensor], rngs=None,
                 train: bool = True, pld_theta=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """:func:`loss_fn` with the LM head and the cross entropy evaluated in
    ``cfg.loss_chunk``-token slices; the same masked mean as
    :func:`next_token_loss`."""
    ids_in, targets, mask, n_tok = _chunk_targets(cfg, batch)
    hidden = forward(cfg, params, ids_in, rngs=rngs, train=train, return_hidden=True,
                     pld_theta=pld_theta)
    return chunked_head_loss(cfg, params, hidden, targets, mask, num_tokens=n_tok)


def loss_fn(cfg: GPTConfig, params: Params, batch: Dict[str, Any], rngs=None,
            train: bool = True, pld_theta=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross entropy. ``batch``: {"input_ids": [B,T]} (+ optional
    "labels"/"loss_mask"), tensors or numpy arrays; chunked over the
    sequence when ``cfg.loss_chunk`` is set."""
    check_config(cfg)
    dev = params["wte"].device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    if cfg.loss_chunk:
        if not cfg.has_lm_head:
            raise ValueError("loss_chunk needs an LM head")
        return chunked_loss(cfg, params, batch, rngs=rngs, train=train, pld_theta=pld_theta)
    return next_token_loss(
        lambda ids: forward(cfg, params, ids, rngs=rngs, train=train, pld_theta=pld_theta),
        cfg.max_seq_len, batch)


# ------------------------------------------------------------- quantized weights
class GPTStream:
    """The model as ``embed`` / ``layer_0..L-1`` / ``final`` units with a host
    (numpy) init per unit, the reference's ``GPTStream`` init: every unit
    draws from its own ``default_rng([seed, unit index])``, so one layer can
    be made without the others. The stream runner's device programs (the
    param-stream offload) are ROADMAP.md A12."""

    def __init__(self, cfg: GPTConfig):
        self.cfg = cfg
        self.n_layer = cfg.n_layer

    def unit_names(self):
        return ["embed"] + [f"layer_{i}" for i in range(self.n_layer)] + ["final"]

    def init_unit(self, name: str, seed: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        d, f, v = cfg.d_model, cfg.ffn_dim, cfg.vocab_size
        idx = self.unit_names().index(name)
        rng = np.random.default_rng([int(seed) & 0x7FFFFFFF, idx])
        std = 0.02
        res_std = float(std / np.sqrt(2.0 * cfg.n_layer))

        def normal(shape, s):
            return rng.standard_normal(shape, np.float32) * np.float32(s)

        def ones(shape):
            return np.ones(shape, np.float32)

        def zeros(shape):
            return np.zeros(shape, np.float32)

        if name == "embed":
            out = {"wte": normal((v, d), std)}
            if not cfg.rotary and not cfg.alibi:
                out["wpe"] = normal((cfg.max_seq_len + cfg.pos_offset, d), std)
            if cfg.embed_layernorm:
                out["emb_ln_scale"] = ones((d,))
                out["emb_ln_bias"] = zeros((d,))
            return out
        if name == "final":
            out = {"lnf_scale": ones((d,)), "lnf_bias": zeros((d,))}
            if not cfg.tie_embeddings:
                out["lm_head"] = normal((v, d), std)
                if cfg.lm_head_bias:
                    out["lm_head_b"] = zeros((v,))
            return out
        return {
            "ln1_scale": ones((d,)), "ln1_bias": zeros((d,)),
            "qkv_w": normal((d, 3 * d), std), "qkv_b": zeros((3 * d,)),
            "attn_out_w": normal((d, d), res_std), "attn_out_b": zeros((d,)),
            "ln2_scale": ones((d,)), "ln2_bias": zeros((d,)),
            "mlp_up_w": normal((d, f), std), "mlp_up_b": zeros((f,)),
            "mlp_down_w": normal((f, d), res_std), "mlp_down_b": zeros((d,)),
        }


def _quantized_leaf(q: torch.Tensor, s: torch.Tensor, bits: int) -> Dict[str, torch.Tensor]:
    """int4 packs two values per byte when the last dim is even."""
    if bits == 4 and q.shape[-1] % 2 == 0:
        return {"q4": pack_int4(q), "s": s}
    return {"q": q, "s": s}


def quantize_for_inference(cfg: GPTConfig, params: Params, bits: int = 8,
                           group_size: int = 128) -> Params:
    """Replace the stacked block weight matrices with int8 ``{"q", "s"}`` (or,
    at ``bits=4``, packed ``{"q4", "s"}``) leaves: each layer's matrix is cut
    into ``group_size`` runs, each with an fp32 scale, and the scales are
    ``[L, groups per layer]``. Leaves of fewer than 3 dims, layer norms and
    matrices whose layer size is not a whole number of groups stay dense.
    The cached paths feed the leaves to the weight kernels (:func:`_wm`)."""
    L = cfg.n_layer
    blocks = {}
    for k, v in params["blocks"].items():
        per_layer = v.numel() // L
        if v.dim() >= 3 and per_layer % group_size == 0 and not k.startswith("ln"):
            ng_l = max(1, per_layer // group_size)
            q, s = quantize(v, bits=bits, num_groups=L * ng_l)
            blocks[k] = _quantized_leaf(q, s.reshape(L, ng_l), bits)
        else:
            blocks[k] = v
    return {**params, "blocks": blocks}


def init_quantized_decode_params(cfg: GPTConfig, seed: int = 0, bits: int = 4,
                                 group_size: int = 128,
                                 compute_dtype: torch.dtype = torch.bfloat16,
                                 device=None) -> Params:
    """The quantized decode tree built without an fp32 model on the device:
    layer units are initialized on the host one at a time
    (:meth:`GPTStream.init_unit`), quantized there (the quantizer of
    :func:`quantize_for_inference`), and only the narrow stacks, the fp32
    scales and the other leaves in ``compute_dtype`` go to ``device``."""
    dev = resolve_device(device)
    stream = GPTStream(cfg)
    stacks: Dict[str, list] = {}
    for i in range(cfg.n_layer):
        for k, v in stream.init_unit(f"layer_{i}", seed).items():
            t = torch.from_numpy(v)
            if v.ndim >= 2 and v.size % group_size == 0 and not k.startswith("ln"):
                q, s = quantize(t, bits=bits, num_groups=v.size // group_size)
                stacks.setdefault(k, []).append(_quantized_leaf(q, s, bits))
            else:
                stacks.setdefault(k, []).append(t.to(compute_dtype))
    blocks: Dict[str, Any] = {}
    for k, per_layer in stacks.items():
        if isinstance(per_layer[0], dict):
            blocks[k] = {kk: torch.stack([leaf[kk] for leaf in per_layer]).to(dev)
                         for kk in per_layer[0]}
        else:
            blocks[k] = torch.stack(per_layer).to(dev)
    params: Params = {"blocks": blocks}
    for unit in ("embed", "final"):
        for k, v in stream.init_unit(unit, seed).items():
            params[k] = torch.from_numpy(v).to(compute_dtype).to(dev)
    return params


def dequantize_params(params: Params) -> Params:
    """The dense tree a quantized tree stands for: each ``{"q"|"q4", "s"}``
    leaf dequantized (in fp32, cast to the dense leaves' dtype) to its
    ``[L, D, F]`` stack; other leaves as they are."""
    dtype = params["lnf_scale"].dtype

    def dense(leaf):
        if not _is_qleaf(leaf):
            return leaf
        q = unpack_int4(leaf["q4"]) if "q4" in leaf else leaf["q"]
        return dequantize(q, leaf["s"].reshape(-1), dtype)

    return {**params, "blocks": {k: dense(v) for k, v in params["blocks"].items()}}


def cast_params(params: Any, device: torch.device, dtype: Optional[torch.dtype]) -> Any:
    """A nested dict of arrays or tensors on ``device``, the floating-point
    leaves cast to ``dtype`` (kept as they are if None); quantized leaves move
    whole (int payloads, fp32 scales), as the reference's engines pass them
    through."""
    if _is_qleaf(params):
        return {k: torch.as_tensor(v).to(device) for k, v in params.items()}
    if isinstance(params, dict):
        return {k: cast_params(v, device, dtype) for k, v in params.items()}
    t = torch.as_tensor(params)
    return t.to(device, dtype if t.is_floating_point() else None)


def has_quantized_leaves(params: Any) -> bool:
    if _is_qleaf(params):
        return True
    return isinstance(params, dict) and any(has_quantized_leaves(v) for v in params.values())


# --------------------------------------------------------------------- KV-cache decode
def init_cache(cfg: GPTConfig, batch_size: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> Dict[str, Any]:
    """Per-layer stacked KV cache: [L, B, H, S, Dh] tensors and ``pos``, the
    number of tokens already written (a Python int)."""
    dev = resolve_device(device)
    shape = (cfg.n_layer, batch_size, cfg.n_head, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev), "pos": 0}


def attn_with_cache(cfg: GPTConfig, x: torch.Tensor, w: Params, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, pos: int, layer_idx: Optional[int] = None):
    """Cached self-attention sublayer (pre-LN + residual).

    x: [B, T, D] new tokens (T = prompt length at prefill, 1 at decode);
    k_cache/v_cache: [B, H, S, Dh]; pos: tokens already in the cache.
    Returns (x + attn_out, k_cache, v_cache). The new keys and values are
    written into the caches IN PLACE (the reference's dynamic_update_slice
    returns new arrays); the returned caches are the same tensors.
    """
    B, T, D = x.shape
    H, Dh = cfg.n_head, cfg.head_dim
    S = k_cache.shape[2]
    if pos + T > S:
        raise ValueError(f"cache of length {S} cannot take {T} tokens at position {pos}")
    positions = pos + torch.arange(T, device=x.device).expand(B, T)
    q, k, v = _qkv(cfg, x, w, positions)
    k_cache[:, :, pos:pos + T] = k.transpose(1, 2).to(k_cache.dtype)
    v_cache[:, :, pos:pos + T] = v.transpose(1, 2).to(v_cache.dtype)
    scale = cfg.attention_scale if cfg.attention_scale is not None else 1.0 / math.sqrt(Dh)
    use_kernel = cfg.use_flash is True or (cfg.use_flash is None and x.is_cuda)
    if cfg.alibi or cfg.local_attention_period > 1:
        use_kernel = False  # the decode kernel has no bias input
    if T == 1 and use_kernel:
        # per-token decode: the decode-attention kernel over the cache
        attn = decode_attention(q.to(k_cache.dtype), k_cache, v_cache, pos + 1,
                                softmax_scale=scale)
    else:
        # prefill: attend over the whole cache with a validity + causal mask
        logits = torch.einsum("bthd,bhsd->bhts", q.float(), k_cache.float()) * scale
        s_idx = torch.arange(S, device=x.device)[None, None, :]
        t_idx = positions[:, :, None]  # each query token's absolute position
        mask = s_idx <= t_idx  # [B, T, S]
        if _is_local_layer(cfg, layer_idx):
            # a windowed layer also drops keys older than window_size
            mask = mask & (s_idx > t_idx - cfg.window_size)
        if cfg.alibi:
            logits = logits + _alibi_bias(cfg, positions, S)
        logits = logits.masked_fill(~mask[:, None], NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        attn = torch.einsum("bhts,bhsd->bthd", probs.to(v_cache.dtype), v_cache)
    attn = attn.reshape(B, T, D).to(x.dtype)
    attn = _wm(attn, w["attn_out_w"]) + w["attn_out_b"]
    return x + attn, k_cache, v_cache


def _block_with_cache(cfg: GPTConfig, x: torch.Tensor, w: Params, k_cache, v_cache,
                      pos: int, layer_idx: Optional[int] = None):
    """One transformer block (attention + dense MLP) over a KV cache slice."""
    y, k_cache, v_cache = attn_with_cache(cfg, x, w, k_cache, v_cache, pos,
                                          layer_idx=layer_idx)
    if cfg.parallel_residual:
        return y + _mlp_delta(cfg, x, w), k_cache, v_cache
    return y + _mlp_delta(cfg, y, w), k_cache, v_cache


def forward_with_cache(cfg: GPTConfig, params: Params, input_ids, cache: Dict[str, Any]):
    """Prefill or decode: run ``input_ids`` [B, T] through the model appending to
    ``cache`` (in place); returns (logits [B, T, V], cache with ``pos`` advanced)."""
    check_config(cfg)
    input_ids = _as_ids(input_ids, params)
    B, T = input_ids.shape
    pos = cache["pos"]
    positions = pos + torch.arange(T, device=input_ids.device).expand(B, T)
    x = _embed(cfg, params, input_ids, positions)
    blocks = params["blocks"]
    for i in range(_n_layers(blocks)):
        x, _, _ = _block_with_cache(cfg, x, _layer(blocks, i), cache["k"][i],
                                    cache["v"][i], pos, layer_idx=i)
    x = layer_norm(x, params["lnf_scale"], params["lnf_bias"], cfg.layer_norm_eps)
    return _head(cfg, params, x), {"k": cache["k"], "v": cache["v"], "pos": pos + T}


# ---------------------------------------------------------------- paged KV decode
KV_QMAX = {8: 127.0, 4: 7.0}


def init_paged_cache(cfg: GPTConfig, num_pages: int, page_size: int,
                     dtype: torch.dtype = torch.bfloat16, kv_bits: Optional[int] = None,
                     device=None) -> Dict[str, torch.Tensor]:
    """Block-allocated KV cache: one shared page pool per layer,
    ``[L, H, P, page_size, Dh]``. Requests own pages through a block table
    (``inference/serving/paging.py``); the pool holds ``P * page_size`` token
    slots shared by every request in flight.

    ``kv_bits`` (8 or 4) stores the pools quantized: int8 payloads (int4
    packs two values per byte along Dh, the ``pack_int4`` layout) and one
    symmetric fp32 scale per (layer, head, page) in ``k_scales``/``v_scales``,
    initialised to 1. A quantized cache is recognized by its scale stacks.
    Page 0 is the allocator's reserved sink: inactive decode slots and
    dropped scatter lanes write there."""
    dev = resolve_device(device)
    if not kv_bits:
        shape = (cfg.n_layer, cfg.n_head, num_pages, page_size, cfg.head_dim)
        return {"k_pages": torch.zeros(shape, dtype=dtype, device=dev),
                "v_pages": torch.zeros(shape, dtype=dtype, device=dev)}
    if kv_bits not in KV_QMAX:
        raise ValueError(f"kv_bits must be 8 or 4 (or None), got {kv_bits}")
    if kv_bits == 4 and cfg.head_dim % 2:
        raise ValueError("int4 KV needs an even head_dim (nibble packing)")
    dq = cfg.head_dim // 2 if kv_bits == 4 else cfg.head_dim
    shape = (cfg.n_layer, cfg.n_head, num_pages, page_size, dq)
    sshape = (cfg.n_layer, cfg.n_head, num_pages)
    return {"k_pages": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v_pages": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scales": torch.ones(sshape, dtype=torch.float32, device=dev),
            "v_scales": torch.ones(sshape, dtype=torch.float32, device=dev)}


def paged_cache_bits(paged_cache: Dict[str, torch.Tensor], head_dim: int) -> Optional[int]:
    """The cache's KV quantization width (None = dense pools)."""
    if "k_scales" not in paged_cache:
        return None
    return 4 if paged_cache["k_pages"].shape[-1] * 2 == head_dim else 8


def paged_kv_bytes_per_token(cfg: GPTConfig, kv_bits: Optional[int] = None,
                             page_size: int = 64,
                             dtype: torch.dtype = torch.bfloat16) -> float:
    """Device bytes one cached token costs in an :func:`init_paged_cache`
    pool: the dense payload at ``dtype``, or the quantized payload at
    ``kv_bits`` plus the fp32 per-(layer, head, page) scales amortized over
    the page."""
    per_tok = 2 * cfg.n_layer * cfg.n_head * cfg.head_dim
    if not kv_bits:
        return float(per_tok * dtype.itemsize)
    payload = per_tok // (2 if kv_bits == 4 else 1)
    scales = 2 * cfg.n_layer * cfg.n_head * 4 / page_size
    return float(payload + scales)


def _pack_kv_int4(q: torch.Tensor) -> torch.Tensor:
    """Values in [-8, 7] packed two per byte along the last dim, the one
    half-split layout (``ops.cuda.int8_matmul.pack_int4``, inverted by
    ``ops.cuda.decode_attention.unpack_kv_int4``)."""
    return pack_int4(q)


def _kv_payload(q: torch.Tensor, bits: int) -> torch.Tensor:
    return _pack_kv_int4(q) if bits == 4 else q.to(torch.int8)


def _host_index(a, device: torch.device) -> torch.Tensor:
    return to_device(np.asarray(a, np.int64), device)


def write_prompt_kv_batch(paged_cache: Dict[str, torch.Tensor],
                          dense_cache: Dict[str, Any], block_tables, lengths,
                          starts=None) -> Dict[str, torch.Tensor]:
    """Scatter a batch of prefilled requests' dense K/V (``dense_cache``
    ``[L, F, H, S, Dh]``) into the pages their block-table rows name, IN
    PLACE (the reference returns new arrays); returns ``paged_cache``.

    ``block_tables`` [F, pages_per_seq], ``lengths`` [F] and ``starts`` [F]
    (or a scalar, default 0) are host arrays, the scheduler's own: the
    positions that land are computed here on the host, so no device mask
    has to be read back. Position s of row f lands iff
    ``starts[f] <= s < lengths[f]``; the rest (bucket padding, rows of
    length 0, positions below a borrowed-prefix start, scratch past the
    table) is dropped, as the reference's out-of-bounds ``mode="drop"``
    drops it.

    Quantized pools quantize at scatter time: one symmetric scale per
    (layer, head, page) from the absmax of the tokens landing in that page,
    payloads rounded and clipped to [-qmax - 1, qmax]."""
    k = dense_cache["k"]  # [L, F, H, S, Dh]
    L, R, H, S, Dh = k.shape
    ps = paged_cache["k_pages"].shape[3]
    dev = paged_cache["k_pages"].device
    tables = np.asarray(block_tables, np.int64).reshape(R, -1)
    lens = np.broadcast_to(np.asarray(lengths, np.int64), (R,))
    st = np.broadcast_to(np.asarray(0 if starts is None else starts, np.int64), (R,))
    pos = np.arange(S)
    valid = (pos[None, :] >= st[:, None]) & (pos[None, :] < lens[:, None])  # [F, S]
    rows, cols = np.nonzero(valid)
    if cols.size and cols.max() // ps >= tables.shape[1]:
        raise ValueError(f"write_prompt_kv_batch: a length reaches past the block table "
                         f"({tables.shape[1]} pages of {ps})")
    f_idx, s_idx = _host_index(rows, dev), _host_index(cols, dev)
    page = _host_index(tables[rows, cols // ps], dev)
    off = _host_index(cols % ps, dev)
    bits = paged_cache_bits(paged_cache, Dh)
    if bits is None:
        for key, pool in (("k", "k_pages"), ("v", "v_pages")):
            dst = paged_cache[pool]
            # dst[l, h, page[n], off[n], :] = dense[l, f_idx[n], h, s_idx[n], :]
            vals = dense_cache[key].permute(1, 3, 0, 2, 4)[f_idx, s_idx]  # [N, L, H, Dh]
            dst[:, :, page, off] = vals.permute(1, 2, 0, 3).to(dst.dtype)
        return paged_cache
    qmax = KV_QMAX[bits]
    npg = -(-S // ps)
    Sp = npg * ps  # S padded up to whole pages for the per-page absmax
    vmask = np.zeros((R, Sp), bool)
    vmask[:, :S] = valid
    vmask = vmask.reshape(R, npg, ps)
    # one scale per (row, page slot) that receives a token
    w_rows, w_slots = np.nonzero(vmask.any(axis=2))
    w_page = _host_index(tables[w_rows, w_slots], dev)
    w_rows_t, w_slots_t = _host_index(w_rows, dev), _host_index(w_slots, dev)
    mask = to_device(vmask.astype(np.float32), dev)[None, None, :, :, :, None]
    for key, pool, skey in (("k", "k_pages", "k_scales"), ("v", "v_pages", "v_scales")):
        xt = dense_cache[key].permute(0, 2, 1, 3, 4).float()  # [L, H, F, S, Dh]
        if Sp != S:
            xt = F.pad(xt, (0, 0, 0, Sp - S))
        xg = xt.reshape(L, H, R, npg, ps, Dh)
        amax = (xg.abs() * mask).amax(dim=(4, 5))  # [L, H, F, npg]
        scales = torch.where(amax > 0, amax / qmax, 1.0)
        q = torch.clamp(torch.round(xg / scales[..., None, None]), -qmax - 1, qmax)
        q = _kv_payload(q, bits)
        q = q.reshape(L, H, R, Sp, q.shape[-1])
        paged_cache[pool][:, :, page, off] = q[:, :, f_idx, s_idx]
        paged_cache[skey][:, :, w_page] = scales[:, :, w_rows_t, w_slots_t]
    return paged_cache


def write_prompt_kv(paged_cache: Dict[str, torch.Tensor], dense_cache: Dict[str, Any],
                    block_table, length: int, row: int = 0,
                    start: int = 0) -> Dict[str, torch.Tensor]:
    """Single-request :func:`write_prompt_kv_batch` over ``dense_cache`` row
    ``row``; ``start`` skips positions below it (borrowed prefix pages)."""
    one = {"k": dense_cache["k"][:, row:row + 1], "v": dense_cache["v"][:, row:row + 1]}
    return write_prompt_kv_batch(paged_cache, one, np.asarray(block_table)[None],
                                 np.asarray([length]), np.asarray([start]))


def _append_kv_token(pages_q: torch.Tensor, scales: torch.Tensor, tok: torch.Tensor,
                     page: torch.Tensor, off: torch.Tensor,
                     bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential quantized-pool append, IN PLACE: one token per batch row
    into its tail page. ``pages_q`` [..., H, P, ps, Dq]; ``scales`` [..., H,
    P]; ``tok`` [..., H, B, Dh] float32; ``page``/``off`` [B] int64. Leading
    dims (the layer stack of :func:`commit_window_kv`) are independent pools,
    each appended as the reference's one-layer call would.

    A row opening a page (offset 0) takes the page scale from its own token
    (the pool's prior value there is garbage: the init, or a recycled page's
    previous tenant). Mid-page the scale grows monotonically, and on a step
    where some row's scale grew, every row's page requantizes under its new
    scale (ratio-1.0 rows round-trip bit for bit). The reference picks the
    requantize branch with ``lax.cond``; here both results are computed and
    ``torch.where`` selects on the device, so no step waits on a host read
    of the condition, and the payloads are the reference's bit for bit."""
    qmax = KV_QMAX[bits]
    B = tok.shape[-2]
    opening = off == 0                                # [B]
    s_old = scales[..., page]                         # [..., H, B]
    amax = tok.abs().amax(dim=-1)
    fresh = torch.where(amax > 0, amax / qmax, 1.0)
    s_new = torch.where(opening, fresh, torch.maximum(s_old, fresh))
    tq = _kv_payload(torch.clamp(torch.round(tok / s_new[..., None]), -qmax - 1, qmax), bits)
    cur = pages_q[..., page, :, :]                    # [..., H, B, ps, Dq]
    deq = unpack_kv_int4(cur) if bits == 4 else cur.float()
    ratio = (s_old / s_new)[..., None, None]
    requant = _kv_payload(torch.clamp(torch.round(deq * ratio), -qmax - 1, qmax), bits)
    grew = (~opening & (s_new > s_old)).flatten(-2).any(-1)  # per pool
    new = torch.where(grew[..., None, None, None, None], requant, cur)
    new[..., torch.arange(B, device=tok.device), off, :] = tq
    pages_q[..., page, :, :] = new
    scales[..., page] = s_new
    return pages_q, scales


def _paged_attn_sublayer(cfg: GPTConfig, x: torch.Tensor, w: Params, k_pages, v_pages,
                         tables: torch.Tensor, lengths: torch.Tensor, impl=None,
                         k_scales=None, v_scales=None) -> torch.Tensor:
    """Cached self-attention over one layer's page pool (pre-LN + residual)
    for ONE new token per row: x [B, 1, D]; pools [H, P, ps, Dh] (or int8
    [..., Dh or Dh/2] with ``k_scales``/``v_scales`` [H, P]); tables [B,
    pages_per_seq] int32; lengths [B] int32, the tokens already cached (the
    new token lands at position ``lengths[b]``). The new K/V are written into
    the pools in place; returns x + attn_out."""
    B, T, D = x.shape
    if T != 1:
        raise ValueError(f"paged decode takes one token per row, got {T}")
    Dh = cfg.head_dim
    ps = k_pages.shape[2]
    q, k, v = _qkv(cfg, x, w, lengths[:, None].long())  # each row at its own position
    page = tables.gather(1, (lengths // ps)[:, None].long())[:, 0].long()
    off = (lengths % ps).long()
    quantized = k_scales is not None
    if not quantized:
        k_pages[:, page, off] = k[:, 0].to(k_pages.dtype).transpose(0, 1)
        v_pages[:, page, off] = v[:, 0].to(v_pages.dtype).transpose(0, 1)
    else:
        bits = 4 if k_pages.shape[-1] * 2 == Dh else 8
        _append_kv_token(k_pages, k_scales, k[:, 0].transpose(0, 1).float(), page, off, bits)
        _append_kv_token(v_pages, v_scales, v[:, 0].transpose(0, 1).float(), page, off, bits)
    scale = cfg.attention_scale if cfg.attention_scale is not None else 1.0 / math.sqrt(Dh)
    qdt = x.dtype if quantized else k_pages.dtype
    attn = paged_decode_attention(q.to(qdt), k_pages, v_pages, lengths + 1, tables,
                                  softmax_scale=scale, impl=impl, k_scales=k_scales,
                                  v_scales=v_scales)
    attn = attn.reshape(B, 1, D).to(x.dtype)
    return x + _wm(attn, w["attn_out_w"]) + w["attn_out_b"]


def paged_decode_step(cfg: GPTConfig, params: Params, input_ids,
                      paged_cache: Dict[str, torch.Tensor], block_tables, lengths,
                      impl: Optional[str] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step over the paged cache: ``input_ids`` [B] (or [B, 1]),
    one new token per slot, each appended at its row's own ``lengths[b]``.
    Returns (logits [B, V], paged_cache), the pools written in place.

    B is the fixed decode slot count: inactive slots (length 0, a table row
    of page 0) write to the sink page and give logits the caller ignores.
    Dense or quantized pools (recognized by the scale stacks); learned or
    rotary positions; the parallel residual. ``impl`` goes to
    :func:`paged_decode_attention` (None: the B4 kernel on CUDA). ALiBi and
    local attention raise the reference's ``ValueError``: B4 has no bias
    input."""
    if cfg.alibi or cfg.local_attention_period > 1:
        raise ValueError("paged decode does not support alibi/local-window attention yet "
                         "(the paged kernel has no bias input)")
    check_config(cfg)
    ids = _as_ids(input_ids, params)
    if ids.dim() == 1:
        ids = ids[:, None]
    dev = ids.device
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    tables = torch.as_tensor(block_tables, dtype=torch.int32, device=dev)
    x = _embed(cfg, params, ids, lengths[:, None].long())
    kv_q = "k_scales" in paged_cache
    blocks = params["blocks"]
    for i in range(_n_layers(blocks)):
        w = _layer(blocks, i)
        y = _paged_attn_sublayer(
            cfg, x, w, paged_cache["k_pages"][i], paged_cache["v_pages"][i], tables,
            lengths, impl=impl, k_scales=paged_cache["k_scales"][i] if kv_q else None,
            v_scales=paged_cache["v_scales"][i] if kv_q else None)
        # parallel residual (NeoX/GPT-J): the MLP reads the pre-attention stream
        x = y + _mlp_delta(cfg, x if cfg.parallel_residual else y, w)
    x = layer_norm(x, params["lnf_scale"], params["lnf_bias"], cfg.layer_norm_eps)
    return _head(cfg, params, x)[:, 0], paged_cache


# ------------------------------------------------------- speculative verification
def _paged_verify_sublayer(cfg: GPTConfig, x: torch.Tensor, w: Params, k_pages, v_pages,
                           tables: torch.Tensor, lengths: torch.Tensor, impl=None,
                           k_scales=None, v_scales=None):
    """Cached self-attention over one layer's page pool for a W-token
    speculation window per row (pre-LN + residual): x [B, W, D]; window
    position i sits at absolute position ``lengths[b] + i`` and attends the
    pool history plus the window's causal prefix. Nothing is written to the
    pool. Returns (x + attn_out, win_k, win_v), the window's K/V [B, W, H,
    Dh] post-rope in the compute dtype: the values sequential decode steps
    would have appended."""
    B, W, D = x.shape
    Dh = cfg.head_dim
    positions = lengths[:, None].long() + torch.arange(W, device=x.device)[None, :]
    q, k, v = _qkv(cfg, x, w, positions)
    scale = cfg.attention_scale if cfg.attention_scale is not None else 1.0 / math.sqrt(Dh)
    # a quantized pool's window stays in the compute dtype (not round-tripped
    # through int8/int4), as the reference's does
    qdt = x.dtype if k_scales is not None else k_pages.dtype
    attn = paged_verify_attention(q.to(qdt), k_pages, v_pages, lengths, tables, k, v,
                                  softmax_scale=scale, impl=impl, k_scales=k_scales,
                                  v_scales=v_scales)
    attn = attn.reshape(B, W, D).to(x.dtype)
    return x + _wm(attn, w["attn_out_w"]) + w["attn_out_b"], k, v


def paged_verify_step(cfg: GPTConfig, params: Params, window_ids, paged_cache: Dict[str, torch.Tensor],
                      block_tables, lengths, impl: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score a speculation window, ``window_ids`` [B, W] per slot (the
    verified next input token, then up to W - 1 drafted tokens), in one pass
    over the paged cache. Returns (logits [B, W, V], win_k, win_v), the
    window's per-layer post-rope K/V [L, B, W, H, Dh] in the compute dtype.

    Every weight matrix is read once for W positions where W sequential
    :func:`paged_decode_step` calls read it W times. The pool is read-only:
    the window K/V stay dense, so a rejected suffix needs no undo, and
    :func:`commit_window_kv` then appends exactly the accepted prefix with
    sequential-append semantics. Over quantized pools the window attends its
    own positions at dense precision where spec-off decode would read them
    int8/int4 round-tripped from the pool, so spec-on equals spec-off there
    only to quantization tolerance, as in the reference. The same support
    as :func:`paged_decode_step`: learned or rotary positions, the parallel
    residual, dense or quantized weights (projections of at most 256 rows
    take the B6/B7 kernels), dense, int8 or int4 pools; alibi and local
    attention raise the reference's ``ValueError``. ``impl`` goes to :func:`paged_verify_attention` (None:
    the B5 kernel on CUDA)."""
    if cfg.alibi or cfg.local_attention_period > 1:
        raise ValueError("paged verification does not support alibi/local-window attention "
                         "yet (same bound as paged_decode_step)")
    check_config(cfg)
    ids = _as_ids(window_ids, params)
    B, W = ids.shape
    dev = ids.device
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    tables = torch.as_tensor(block_tables, dtype=torch.int32, device=dev)
    positions = lengths[:, None].long() + torch.arange(W, device=dev)[None, :]
    # a window at the end of the model length may reach past the learned
    # position table; those positions are never committed (the budget and
    # admission bound them), so their lookups are clamped into the table
    x = _embed(cfg, params, ids, positions.clamp(max=cfg.max_seq_len - 1 - cfg.pos_offset))
    kv_q = "k_scales" in paged_cache
    blocks = params["blocks"]
    win_k, win_v = [], []
    for i in range(_n_layers(blocks)):
        w = _layer(blocks, i)
        y, k, v = _paged_verify_sublayer(
            cfg, x, w, paged_cache["k_pages"][i], paged_cache["v_pages"][i], tables, lengths,
            impl=impl, k_scales=paged_cache["k_scales"][i] if kv_q else None,
            v_scales=paged_cache["v_scales"][i] if kv_q else None)
        x = y + _mlp_delta(cfg, x if cfg.parallel_residual else y, w)
        win_k.append(k)
        win_v.append(v)
    x = layer_norm(x, params["lnf_scale"], params["lnf_bias"], cfg.layer_norm_eps)
    return _head(cfg, params, x), torch.stack(win_k), torch.stack(win_v)


def commit_window_kv(paged_cache: Dict[str, torch.Tensor], win_k: torch.Tensor,
                     win_v: torch.Tensor, block_tables, lengths, n_commit
                     ) -> Dict[str, torch.Tensor]:
    """Append each row's ACCEPTED window prefix, ``n_commit[b]`` tokens at
    positions ``lengths[b] .. lengths[b] + n_commit[b] - 1``, into the paged
    pool IN PLACE (the reference returns new arrays), exactly as
    ``n_commit[b]`` sequential decode steps would have; returns
    ``paged_cache``. ``win_k``/``win_v`` [L, B, W, H, Dh]; ``block_tables``
    [B, pages_per_seq]; ``lengths`` [B], the pool tokens before the window;
    ``n_commit`` [B] in 0..W, which may live on the device (nothing here
    reads it on the host).

    Uncommitted window positions write to the sink page 0 at offset ``pos %
    page_size`` (the page index clipped to the table), so a rejected suffix
    is the absence of a write. Quantized pools take one
    :func:`_append_kv_token` per window step, in order (the page-scale
    semantics depend on it), over all layers at once; dense pools take one
    scatter of all W positions: committed (page, offset) pairs are distinct,
    so it equals the sequential writes."""
    k_pages = paged_cache["k_pages"]
    dev = k_pages.device
    L, B, W, H, Dh = win_k.shape
    ps = k_pages.shape[3]
    tables = torch.as_tensor(block_tables, dtype=torch.int32, device=dev).long()
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev).long()
    n_commit = torch.as_tensor(n_commit, device=dev).long()
    steps = torch.arange(W, device=dev)
    pos = lengths[None, :] + steps[:, None]                               # [W, B]
    pidx = torch.clamp(pos // ps, 0, tables.shape[1] - 1)
    table_page = tables.gather(1, pidx.t()).t()                           # [W, B]
    page = torch.where(steps[:, None] < n_commit[None, :], table_page, 0)
    off = pos % ps
    bits = paged_cache_bits(paged_cache, Dh)
    if bits is None:
        # step-major order: where the sink page takes several writes at one
        # offset, the last step's lands, as the sequential writes leave it
        flat_page, flat_off = page.reshape(-1), off.reshape(-1)
        for win, pool in ((win_k, "k_pages"), (win_v, "v_pages")):
            dst = paged_cache[pool]
            vals = win.permute(0, 3, 2, 1, 4).reshape(L, H, W * B, Dh)   # [L, H, W*B, Dh]
            dst[:, :, flat_page, flat_off] = vals.to(dst.dtype)
        return paged_cache
    for i in range(W):
        for win, pool, skey in ((win_k, "k_pages", "k_scales"), (win_v, "v_pages", "v_scales")):
            tok = win[:, :, i].permute(0, 2, 1, 3).float()                 # [L, H, B, Dh]
            _append_kv_token(paged_cache[pool], paged_cache[skey], tok, page[i], off[i], bits)
    return paged_cache


# --------------------------------------------------------------------------- module
class GPTModel(nn.Module):
    """Owns a GPT parameter dict (the functional layout above) as frozen
    ``nn.Parameter``s and runs the functional forward and loss on it, for
    inference; no parameter needs grad. Training goes through
    ``deepspeed_tpu_torch.initialize(model=build(...)[0], ...)``."""

    def __init__(self, cfg: GPTConfig, params: Optional[Params] = None,
                 seed: int = 0, device=None):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, seed, device=device)

        def frozen(d):
            return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                     for k, v in d.items()})

        self.blocks = frozen(params["blocks"])
        self.top = frozen({k: v for k, v in params.items() if k != "blocks"})

    def params(self) -> Params:
        return {**dict(self.top.items()), "blocks": dict(self.blocks.items())}

    def forward(self, input_ids) -> torch.Tensor:
        return forward(self.cfg, self.params(), input_ids, train=False)

    def loss(self, batch: Dict[str, Any]) -> torch.Tensor:
        return loss_fn(self.cfg, self.params(), batch, train=False)[0]


# --------------------------------------------------------------------------- build
def build(cfg_or_name: Union[str, GPTConfig]) -> Tuple[Module, GPTConfig]:
    """A trainable :class:`~.api.Module` from a config or preset name: its
    ``init(seed, device)`` is :func:`init_params` and its ``apply`` is
    :func:`loss_fn`."""
    cfg = PRESETS[cfg_or_name] if isinstance(cfg_or_name, str) else cfg_or_name
    check_config(cfg)

    def init(seed: Union[int, torch.Generator] = 0, device=None) -> Params:
        return init_params(cfg, seed, device=device)

    def apply(params, batch, rngs=None, train: bool = True, pld_theta=None):
        return loss_fn(cfg, params, batch, rngs=rngs, train=train, pld_theta=pld_theta)

    return Module(init=init, apply=apply, gpt_config=cfg), cfg
