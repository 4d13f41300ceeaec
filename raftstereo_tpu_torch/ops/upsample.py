"""Learned convex upsampling of the low-resolution disparity field."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def extract_3x3_patches(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, 9, C) zero-padded 3x3 neighbourhoods,
    patch index k = ky*3 + kx (``F.unfold``'s order)."""
    b, h, w, c = x.shape
    p = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack([p[:, ky:ky + h, kx:kx + w, :]
                        for ky in range(3) for kx in range(3)], dim=3)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor,
                    factor: int) -> torch.Tensor:
    """Upsample (B, H, W, D) -> (B, factor*H, factor*W, D) by a softmax-
    convex combination over each pixel's 3x3 coarse neighbourhood.
    ``mask`` is (B, H, W, 9*factor*factor), channel ((k*factor + fy)*factor
    + fx); values scale by ``factor`` (pixels of the finer resolution)."""
    b, h, w, d = flow.shape
    mask = mask.reshape(b, h, w, 9, factor, factor).float().softmax(dim=3)
    patches = extract_3x3_patches(flow.float() * factor)
    up = torch.einsum("bhwkd,bhwkyx->bhywxd", patches, mask)
    return up.reshape(b, h * factor, w * factor, d)
