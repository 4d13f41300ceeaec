"""Building blocks: norms, convs and residual blocks (NCHW inside the
model; the JAX package's ``models/layers.py`` is the reference)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv(cin: int, cout: int, kernel: int, stride: int = 1,
         padding=None) -> nn.Conv2d:
    """Conv2d with symmetric padding ``kernel // 2`` unless given."""
    if padding is None:
        padding = kernel // 2
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding)


class InstanceNorm(nn.Module):
    """Per-image, per-channel normalization over (H, W): no affine
    parameters, eps 1e-5, variance from centred squares."""

    def forward(self, x):
        m = x.mean(dim=(2, 3), keepdim=True)
        c = x - m
        v = (c * c).mean(dim=(2, 3), keepdim=True)
        return c * torch.rsqrt(v + 1e-5)


class FrozenBatchNorm(nn.Module):
    """Batch norm with frozen running statistics, eps 1e-5 (the JAX
    package always runs batch norm on its running averages)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + 1e-5) * self.weight
        return ((x - self.running_mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


def make_norm(norm_fn: str, channels: int) -> nn.Module:
    """Norm factory: "batch" (frozen) or "instance"."""
    if norm_fn == "batch":
        return FrozenBatchNorm(channels)
    if norm_fn == "instance":
        return InstanceNorm()
    raise NotImplementedError(f"norm {norm_fn!r} is not ported yet; see "
                              f"ROADMAP.md Queue 1 item 3")


class ResidualBlock(nn.Module):
    """Two 3x3 convs with norms and an identity or projection shortcut."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1):
        super().__init__()
        self.conv1 = conv(in_planes, planes, 3, stride)
        self.conv2 = conv(planes, planes, 3)
        self.norm1 = make_norm(norm_fn, planes)
        self.norm2 = make_norm(norm_fn, planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                conv(in_planes, planes, 1, stride, padding=0),
                make_norm(norm_fn, planes))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation: kaiming-normal (fan_out, relu) conv weights,
    zero biases, identity batch norms.  A GRU's fused z/r conv draws with
    the fan_out of ONE gate, as two separate convs would."""
    for name, m in module.named_modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            if name.endswith("convzr"):
                fan_out //= 2
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * (2.0 / fan_out) ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
