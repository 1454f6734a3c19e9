"""Counter-based seeds for the port's random draws.

The reference derives every dropout key from the step key with
``jax.random.fold_in(key, layer)`` and ``fold_in(key, salt)``; the port does
the same with integer seeds, so a draw depends only on (step seed, layer,
salt) and never on how many draws came before it. That is what lets
activation checkpointing recompute a block and draw the very same dropout
mask. The bits differ from JAX's: tests compare seeds, not masks.
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (the splitmix64 finaliser)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1
