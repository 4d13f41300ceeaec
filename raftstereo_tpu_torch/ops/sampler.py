"""1-D linear sampling along the last axis: the lookup primitive of the
``reg`` correlation backend.

The port's own copy of the JAX package's ``ops/sampler.py``
``linear_sample_1d``: pixel coordinates, align_corners, zero outside
[0, W-1] (the reference's ``bilinear_sampler`` on a 1-D volume).
"""

from __future__ import annotations

import torch


def linear_sample_1d(vol: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sample ``vol`` (..., W) at fractional positions ``x`` (..., K).

    Leading dims of ``vol`` and ``x`` must match.  Returns (..., K) fp32
    with out-of-bounds taps treated as zero; a NaN position gives NaN.
    The validity test runs in float before any integer cast, so NaN and
    huge positions never reach the gather."""
    w = vol.shape[-1]
    x = x.float()
    x0 = torch.floor(x)
    dx = x - x0
    if w == 0:
        return torch.zeros_like(x)
    zero = torch.zeros((), device=x.device)

    def take(j):
        valid = (j >= 0) & (j <= w - 1)  # False for NaN
        v = torch.gather(vol, -1, torch.where(valid, j, zero).long())
        return torch.where(valid, v.float(), zero)

    return take(x0) * (1.0 - dx) + take(x0 + 1.0) * dx
