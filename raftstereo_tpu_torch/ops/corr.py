"""Correlation pyramid state and the on-demand lookup over it.

The counterpart of the JAX package's ``pallas_alt`` backend
(``ops/corr.py`` ``build_corr_state`` / ``corr_fn_from_state``): fmap2 is
average-pooled along W by 2 per level with floor halving, and each lookup
recomputes only the correlation taps it needs.  The TPU form pads every
level to 128 lanes and concatenates the padded levels; here the levels
are concatenated at their real widths, which is the same function (the
TPU's padded columns correlate to exactly zero).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from .cuda_alt import alt_corr


def build_fmap2_pyramid(fmap2: torch.Tensor,
                        num_levels: int) -> List[torch.Tensor]:
    """Pool fmap2 (B, H, W, C) along W by 2 per level, floor-halving."""
    b, h, _, c = fmap2.shape
    pyramid = [fmap2]
    for _ in range(num_levels - 1):
        f2 = pyramid[-1]
        w = f2.shape[2] // 2
        pyramid.append(f2[:, :, :2 * w].reshape(b, h, w, 2, c).mean(dim=3))
    return pyramid


class CorrState(NamedTuple):
    """On-demand lookup state: fmap1 (B, H, W1, C), the fmap2 pyramid
    concatenated along W at its real level widths (B, H, sum(widths), C),
    and those widths."""

    fmap1: torch.Tensor
    f2cat: torch.Tensor
    widths: Tuple[int, ...]


def build_corr_state(fmap1: torch.Tensor, fmap2: torch.Tensor,
                     num_levels: int) -> CorrState:
    """Build the lookup state once per pair (fp32, contiguous)."""
    pyr = build_fmap2_pyramid(fmap2.float(), num_levels)
    return CorrState(fmap1.float().contiguous(),
                     torch.cat(pyr, dim=2).contiguous(),
                     tuple(p.shape[2] for p in pyr))


def corr_lookup(state: CorrState, x: torch.Tensor,
                radius: int) -> torch.Tensor:
    """Correlation features at level-0 x-coordinates ``x`` (B, H, W1):
    (B, H, W1, L*(2r+1)), channels level-major, taps -r..r."""
    return alt_corr(state.fmap1, state.f2cat, state.widths,
                    x.float().contiguous(), radius)
