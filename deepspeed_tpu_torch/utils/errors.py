"""The error every not-yet-ported option raises."""

from __future__ import annotations


def unported(what: str, item: str) -> NotImplementedError:
    """``what`` is not ported yet; ``item`` names its entry in ROADMAP.md."""
    return NotImplementedError(
        f"{what} is not ported to deepspeed_tpu_torch yet (ROADMAP.md {item})")
