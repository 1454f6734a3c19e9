"""The ulp metric the port's flash-backward tests share: how many rounding
steps of a 16-bit format two gradients are apart."""

import torch


def ulp_err(x: torch.Tensor, ref: torch.Tensor, dtype: torch.dtype,
            floor: float = 1e-3) -> float:
    """Largest |x - ref| in ulps of ``dtype`` at ref, over the entries with
    |ref| at least ``floor`` of the largest. An ulp of a value in
    [2^e, 2^(e+1)) is eps 2^e (eps = 2^-7 for bf16, 2^-10 for fp16), and
    eps times the smallest normal below the normal range."""
    info = torch.finfo(dtype)
    r = ref.float()
    keep = r.abs() >= floor * r.abs().max()
    _, ex = torch.frexp(r[keep])  # |r| = f 2^ex, f in [0.5, 1)
    ulp = info.eps * torch.clamp(torch.ldexp(torch.ones_like(r[keep]), ex - 1), min=info.tiny)
    return ((x.float()[keep] - r[keep]).abs() / ulp).max().item()
