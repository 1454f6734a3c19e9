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
  kernel on CUDA when eligible) and the cached decode step through the
  decode-attention kernel; the dense projections stay ``torch.matmul``.

:class:`GPTModel` is a thin ``nn.Module`` that owns such a parameter dict.
Options this slice does not port raise ``NotImplementedError`` naming the
``ROADMAP.md`` item that will port them (:func:`check_config`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..accelerator import resolve_device
from ..ops.attention import multihead_attention
from ..ops.cuda.decode_attention import decode_attention
from ..ops.cuda.flash_attention import NEG_INF

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
    dropout: float = 0.0  # training only (ROADMAP.md A3)
    layer_norm_eps: float = 1e-5
    activation: str = "gelu"  # "gelu" (tanh approx), "gelu_exact", "relu", "quick_gelu"
    parallel_residual: bool = False  # NeoX-style x + attn(ln1 x) + mlp(ln2 x)
    pos_offset: int = 0  # learned-position index offset (OPT uses 2)
    alibi: bool = False  # not ported (ROADMAP.md A2b)
    rotary_interleaved: bool = False  # GPT-J rotate_every_two vs NeoX rotate_half
    embed_layernorm: bool = False  # Bloom: LN right after the token embedding
    lm_head_bias: bool = False  # GPT-J: bias on the (untied) LM head
    remat: bool = False  # activation checkpointing: a training memory knob (A3)
    remat_policy: str = "nothing_saveable"
    use_flash: Optional[bool] = None  # None = auto dispatch (the kernels on CUDA)
    # the reference's Pallas tile sizes; the CUDA kernels fix their own tiles
    # (64 rows), and the tile size does not change the result
    flash_block_q: int = 256
    flash_block_k: int = 256
    stochastic_mode: bool = False  # bf16 flash operands: raises in the kernel (B1 redesign)
    stochastic_depth: float = 0.0  # training only (A3)
    local_attention_period: int = 0  # not ported (A2b)
    window_size: int = 256
    attention_scale: Optional[float] = None  # None = 1/sqrt(head_dim)
    has_lm_head: bool = True  # False: pure encoder, only return_hidden=True is valid
    sparse_attention: Optional[Any] = None  # not ported (A13, kernel B9)
    random_ltd_layer_ids: Tuple[int, ...] = ()  # training only (A3)
    random_ltd_keep: Optional[int] = None
    seq_parallel_impl: str = "dense"  # "ring" / "ulysses" not ported (A13)
    loss_chunk: int = 0  # chunked cross-entropy, not ported (A2b)

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


def unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to deepspeed_tpu_torch yet (ROADMAP.md {item})")


def check_config(cfg: GPTConfig) -> None:
    """Raise for a config option whose semantics this slice does not port."""
    if cfg.alibi:
        raise unported("GPTConfig.alibi (ALiBi attention bias)", "A2b")
    if cfg.local_attention_period > 1:
        raise unported("GPTConfig.local_attention_period (local attention)", "A2b")
    if cfg.loss_chunk:
        raise unported("GPTConfig.loss_chunk (chunked cross-entropy)", "A2b")
    if cfg.sparse_attention is not None:
        raise unported("GPTConfig.sparse_attention", "A13 and kernel B9")
    if cfg.seq_parallel_impl != "dense":
        raise unported(f"seq_parallel_impl={cfg.seq_parallel_impl!r} "
                       "(sequence-parallel attention)", "A13")


def _check_train(cfg: GPTConfig, train: bool, pld_theta) -> None:
    if pld_theta is not None:
        raise unported("progressive layer drop (pld_theta)", "A3")
    if train and (cfg.dropout > 0.0 or cfg.stochastic_depth > 0.0
                  or (cfg.random_ltd_keep is not None and cfg.random_ltd_layer_ids)):
        raise unported("a training-mode forward with dropout, stochastic depth "
                       "or random-LTD", "A3")


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


def _act(cfg: GPTConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "relu":
        return F.relu(h)
    if cfg.activation == "gelu_exact":
        return F.gelu(h)
    if cfg.activation == "quick_gelu":  # CLIP: x * sigmoid(1.702 x)
        return h * torch.sigmoid(1.702 * h)
    return F.gelu(h, approximate="tanh")


def _wm(h: torch.Tensor, leaf) -> torch.Tensor:
    """``h @ W`` for a dense weight; quantized ``{"q","s"}`` leaves are not ported."""
    if not isinstance(leaf, torch.Tensor):
        raise unported("quantized weight leaves (the int8/int4 _wm dispatch)", "A8")
    return h @ leaf


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


def _attention_delta(cfg: GPTConfig, x: torch.Tensor, w: Params,
                     positions: torch.Tensor) -> torch.Tensor:
    """Attention output (pre-residual): attn_out(MHA(ln1(x)))."""
    B, T, D = x.shape
    q, k, v = _qkv(cfg, x, w, positions)
    attn = multihead_attention(q, k, v, causal=True, use_flash=cfg.use_flash,
                               softmax_scale=cfg.attention_scale,
                               stochastic_mode=cfg.stochastic_mode)
    return _wm(attn.reshape(B, T, D), w["attn_out_w"]) + w["attn_out_b"]


def _mlp_delta(cfg: GPTConfig, x: torch.Tensor, w: Params) -> torch.Tensor:
    """MLP output (pre-residual): mlp(ln2(x))."""
    h = layer_norm(x, w["ln2_scale"], w["ln2_bias"], cfg.layer_norm_eps)
    h = _act(cfg, _wm(h, w["mlp_up_w"]) + w["mlp_up_b"])
    return _wm(h, w["mlp_down_w"]) + w["mlp_down_b"]


def _block(cfg: GPTConfig, x: torch.Tensor, w: Params,
           positions: torch.Tensor) -> torch.Tensor:
    if cfg.parallel_residual:
        # NeoX/GPT-J style: both sublayers read the same input
        return x + _attention_delta(cfg, x, w, positions) + _mlp_delta(cfg, x, w)
    x = x + _attention_delta(cfg, x, w, positions)
    return x + _mlp_delta(cfg, x, w)


def _layer(blocks: Params, i: int) -> Params:
    return {k: v[i] for k, v in blocks.items()}


def _embed(cfg: GPTConfig, params: Params, input_ids: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    x = F.embedding(input_ids, params["wte"])
    if not cfg.rotary and not cfg.alibi:
        x = x + F.embedding(positions + cfg.pos_offset, params["wpe"])
    if cfg.embed_layernorm:
        x = layer_norm(x, params["emb_ln_scale"], params["emb_ln_bias"], cfg.layer_norm_eps)
    qkv_w = params["blocks"]["qkv_w"]
    if not isinstance(qkv_w, torch.Tensor):
        raise unported("quantized weight leaves (the int8/int4 _wm dispatch)", "A8")
    return x.to(qkv_w.dtype)


def _head(cfg: GPTConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    head = params["wte"] if cfg.tie_embeddings else params["lm_head"]
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
    ``return_hidden``). Dropout, stochastic depth, random-LTD and progressive
    layer drop belong to the training slice and raise when active; ``rngs`` is
    accepted for the reference's signature and unused."""
    check_config(cfg)
    _check_train(cfg, train, pld_theta)
    input_ids = _as_ids(input_ids, params)
    B, T = input_ids.shape
    if T > cfg.max_seq_len:
        raise ValueError(f"sequence length {T} exceeds max_seq_len {cfg.max_seq_len}")
    positions = torch.arange(T, device=input_ids.device).expand(B, T)
    x = _embed(cfg, params, input_ids, positions)
    blocks = params["blocks"]
    for i in range(blocks["qkv_w"].shape[0]):
        x = _block(cfg, x, _layer(blocks, i), positions)
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


def loss_fn(cfg: GPTConfig, params: Params, batch: Dict[str, Any], rngs=None,
            train: bool = True, pld_theta=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross entropy. ``batch``: {"input_ids": [B,T]} (+ optional
    "labels"/"loss_mask"), tensors or numpy arrays."""
    check_config(cfg)
    dev = params["wte"].device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    return next_token_loss(
        lambda ids: forward(cfg, params, ids, rngs=rngs, train=train, pld_theta=pld_theta),
        cfg.max_seq_len, batch)


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
    if T == 1 and use_kernel:
        # per-token decode: the decode-attention kernel over the cache
        attn = decode_attention(q.to(k_cache.dtype), k_cache, v_cache, pos + 1,
                                softmax_scale=scale)
    else:
        # prefill: attend over the whole cache with a validity + causal mask
        logits = torch.einsum("bthd,bhsd->bhts", q.float(), k_cache.float()) * scale
        mask = torch.arange(S, device=x.device)[None, None, :] <= positions[:, :, None]
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
    for i in range(blocks["qkv_w"].shape[0]):
        x, _, _ = _block_with_cache(cfg, x, _layer(blocks, i), cache["k"][i],
                                    cache["v"][i], pos, layer_idx=i)
    x = layer_norm(x, params["lnf_scale"], params["lnf_bias"], cfg.layer_norm_eps)
    return _head(cfg, params, x), {"k": cache["k"], "v": cache["v"], "pos": pos + T}


# --------------------------------------------------------------------------- module
class GPTModel(nn.Module):
    """Owns a GPT parameter dict (the functional layout above) as frozen
    ``nn.Parameter``s and runs the functional forward and loss on it.
    Training is not ported yet (ROADMAP.md A3), so no parameter needs grad."""

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
