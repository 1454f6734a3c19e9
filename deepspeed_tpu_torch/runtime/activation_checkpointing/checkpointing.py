"""Activation checkpointing (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``).

The reference's API on PyTorch's facilities:

- :func:`checkpoint` / :func:`checkpoint_wrapper` recompute a function's
  activations in the backward through ``torch.utils.checkpoint(...,
  use_reentrant=False)``; the config's ``policy_name`` (one of
  ``models.gpt.REMAT_POLICIES``) picks what is saved instead, through
  PyTorch's selective checkpointing (``everything_saveable`` runs the
  function plainly);
- ``cpu_checkpointing`` runs the checkpointed call under
  ``torch.autograd.graph.save_on_cpu(pin_memory=True)``: what the region
  keeps for its recompute (its inputs) waits in pinned host memory and
  comes back for the backward;
- ``partition_activations`` is accepted and changes nothing: the reference
  shards saved activations over the model-parallel axes (tp, sp), which are
  of size 1 until the port has them (ROADMAP.md A10 / A13);
- ``contiguous_memory_optimization``, ``number_checkpoints`` and
  ``synchronize_checkpoint_boundary`` are accepted and ignored, as in the
  reference; ``profile`` names each checkpointed call in a profiler trace;
- :class:`RNGStatesTracker` keeps named ``torch.Generator`` streams.

The configuration is process-wide, as the reference's is: the engine calls
:func:`configure` with its config unless a user configured the module first
and the config's block is the default.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint



@dataclasses.dataclass
class CheckpointConfig:
    """The resolved knobs (the reference's module-level settings)."""

    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    # what a checkpointed call saves instead of recomputing
    policy_name: str = "nothing_saveable"


_config = CheckpointConfig()
_configured = False


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None) -> None:
    """Set the process-wide configuration from a parsed DeepSpeed config's
    ``activation_checkpointing`` block and / or explicit overrides."""
    global _config, _configured
    cfg = CheckpointConfig()
    block = getattr(deepspeed_config, "activation_checkpointing", None)
    if block is not None:
        for f in ("partition_activations", "cpu_checkpointing",
                  "contiguous_memory_optimization", "number_checkpoints",
                  "synchronize_checkpoint_boundary", "profile"):
            setattr(cfg, f, getattr(block, f))
    for name, value in (("partition_activations", partition_activations),
                        ("contiguous_memory_optimization", contiguous_checkpointing),
                        ("number_checkpoints", num_checkpoints),
                        ("cpu_checkpointing", checkpoint_in_cpu),
                        ("synchronize_checkpoint_boundary", synchronize),
                        ("profile", profile)):
        if value is not None:
            setattr(cfg, name, value)
    _config = cfg
    _configured = True


def is_configured() -> bool:
    return _configured


def reset() -> None:
    """Back to the defaults, unconfigured."""
    global _config, _configured
    _config = CheckpointConfig()
    _configured = False


def policy_from_config(cfg: Optional[CheckpointConfig] = None) -> Optional[Callable]:
    """The ``context_fn`` of ``torch.utils.checkpoint`` for the config's
    policy, or None for ``nothing_saveable`` (recompute everything)."""
    from ...models.gpt import _SAVED_DOTS, REMAT_POLICIES

    cfg = cfg or _config
    name = cfg.policy_name
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown checkpoint policy {name!r}; one of {REMAT_POLICIES}")
    if name in ("nothing_saveable", "everything_saveable"):
        return None
    if name == "save_attn_mlp_out":
        raise ValueError("save_attn_mlp_out names GPT blocks' projections: set it as "
                         "GPTConfig.remat_policy")
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    dots = _SAVED_DOTS[name]

    def policy_fn(ctx, func, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if func.overloadpacket in dots
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def checkpoint(function: Callable, *args) -> Any:
    """``function(*args)`` with its activations recomputed in the backward,
    under the configured options."""
    return checkpoint_wrapper(function)(*args)


def checkpoint_wrapper(function: Callable,
                       cfg: Optional[CheckpointConfig] = None) -> Callable:
    """``function`` made to recompute its activations in the backward, under
    ``cfg`` (default: the configured options, read now)."""
    cfg = cfg or _config
    context_fn = policy_from_config(cfg)
    plain = cfg.policy_name == "everything_saveable"

    @functools.wraps(function)
    def wrapped(*args, **kwargs):
        with contextlib.ExitStack() as stack:
            if cfg.profile:
                stack.enter_context(torch.profiler.record_function("activation_checkpoint"))
            if cfg.cpu_checkpointing:
                stack.enter_context(torch.autograd.graph.save_on_cpu(pin_memory=True))
            if plain or not torch.is_grad_enabled():
                return function(*args, **kwargs)
            kw = {"context_fn": context_fn} if context_fn is not None else {}
            return _torch_checkpoint(function, *args, use_reentrant=False, **kw, **kwargs)

    return wrapped


class RNGStatesTracker:
    """Named random streams on ``torch.Generator``s (the reference's
    ``CudaRNGStatesTracker``): ``add(name, seed)`` starts one,
    ``fork(name)`` draws the next seed of that stream, and
    ``get_states`` / ``set_states`` save and restore every stream, as a
    recompute needs."""

    def __init__(self):
        self.states = {}

    def reset(self):
        self.states = {}

    def get_states(self):
        return {name: gen.get_state() for name, gen in self.states.items()}

    def set_states(self, states):
        for name, state in states.items():
            if name not in self.states:
                self.states[name] = torch.Generator()
            self.states[name].set_state(state)

    def add(self, name: str, seed: int):
        if name in self.states:
            raise Exception(f"RNG state {name} already exists")
        self.states[name] = torch.Generator().manual_seed(int(seed))

    def fork(self, name: str = "model-parallel-rng") -> int:
        """The next seed of the named stream (it advances the stream)."""
        if name not in self.states:
            raise Exception(f"RNG state {name} not added")
        return int(torch.randint(0, 2 ** 62, (), generator=self.states[name]))


_tracker = RNGStatesTracker()


def get_rng_tracker() -> RNGStatesTracker:
    return _tracker


def model_parallel_reseed(seed: int, axis_name: str = "tp") -> int:
    """``seed`` with this rank's model-parallel coordinate folded in, so that
    tp ranks draw distinct dropout. The port has no model-parallel axis
    (ROADMAP.md A13), so the seed comes back unchanged, as the reference
    returns its key outside a bound axis."""
    return seed
