"""Feature and context encoders (the JAX package's plain stem path,
``models/encoders.py`` ``_plain_stem``).  Module names follow the
upstream PyTorch RAFT-Stereo so the weight bridge maps one to one."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch.nn as nn
import torch.nn.functional as F

from .layers import ResidualBlock, conv, make_norm


def _trunk(enc, norm_fn: str, downsample: int) -> None:
    """conv1 -> norm1 -> layer1..layer3, strides from ``downsample``."""
    d = downsample
    enc.conv1 = conv(3, 64, 7, stride=1 + (d > 2), padding=3)
    enc.norm1 = make_norm(norm_fn, 64)
    enc.layer1 = nn.Sequential(ResidualBlock(64, 64, norm_fn),
                               ResidualBlock(64, 64, norm_fn))
    enc.layer2 = nn.Sequential(ResidualBlock(64, 96, norm_fn, 1 + (d > 1)),
                               ResidualBlock(96, 96, norm_fn))
    enc.layer3 = nn.Sequential(ResidualBlock(96, 128, norm_fn, 1 + (d > 0)),
                               ResidualBlock(128, 128, norm_fn))


def _run_trunk(enc, x):
    x = F.relu(enc.norm1(enc.conv1(x)))
    return enc.layer3(enc.layer2(enc.layer1(x)))


class BasicEncoder(nn.Module):
    """Residual trunk -> ``output_dim`` feature maps at 1/2^downsample."""

    def __init__(self, output_dim: int = 256, norm_fn: str = "instance",
                 downsample: int = 2):
        super().__init__()
        _trunk(self, norm_fn, downsample)
        self.conv2 = conv(128, output_dim, 1, padding=0)

    def forward(self, x):
        return self.conv2(_run_trunk(self, x))


class MultiBasicEncoder(nn.Module):
    """Context encoder: the trunk plus two stride-2 stages, with per-level
    output heads.  ``output_dims`` holds one channel tuple per head group
    (hidden state, context), finest level first.  Only the levels the
    model runs (``num_layers``) are built, as the JAX package creates
    parameters only for those."""

    def __init__(self, output_dims: Sequence[Tuple[int, ...]],
                 norm_fn: str = "batch", downsample: int = 2,
                 num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        _trunk(self, norm_fn, downsample)
        self.outputs08 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, norm_fn),
                          conv(128, dims[0], 3)) for dims in output_dims)
        if num_layers >= 2:
            self.layer4 = nn.Sequential(ResidualBlock(128, 128, norm_fn, 2),
                                        ResidualBlock(128, 128, norm_fn))
            self.outputs16 = nn.ModuleList(
                nn.Sequential(ResidualBlock(128, 128, norm_fn),
                              conv(128, dims[1], 3)) for dims in output_dims)
        if num_layers >= 3:
            self.layer5 = nn.Sequential(ResidualBlock(128, 128, norm_fn, 2),
                                        ResidualBlock(128, 128, norm_fn))
            self.outputs32 = nn.ModuleList(conv(128, dims[2], 3)
                                           for dims in output_dims)

    def forward(self, x) -> List[List]:
        """``out[level][head]``, finest level first."""
        x = _run_trunk(self, x)
        outputs = [[head(x) for head in self.outputs08]]
        if self.num_layers >= 2:
            y = self.layer4(x)
            outputs.append([head(y) for head in self.outputs16])
        if self.num_layers >= 3:
            z = self.layer5(y)
            outputs.append([head(z) for head in self.outputs32])
        return outputs
