"""Building blocks: norms, convs and residual blocks (NCHW inside the
model; the JAX package's ``models/layers.py`` is the reference).

Each block computes in its input's dtype.  fp32 inputs take the fp32
arithmetic as before.  bf16 inputs follow flax's ``dtype=bfloat16``
modules: parameters stay fp32 and are cast at use, a convolution's output
is rounded to bf16 before its bias is added in bf16, batch norm computes
in fp32 and rounds once, and instance norm keeps the JAX package's
``instance_norm_stats`` rounding points."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


BF16 = torch.bfloat16


def conv_bf16(x: torch.Tensor, weight: torch.Tensor, bias, stride=1,
              padding=0) -> torch.Tensor:
    """flax ``nn.Conv(dtype=bfloat16)``: input and kernel in bf16, the
    product rounded to bf16 (fp32 accumulation inside), then the bias
    added in bf16 -- one rounding more than ``F.conv2d(x, w, b)``."""
    y = F.conv2d(x.to(BF16), weight.to(BF16), None, stride, padding)
    return y if bias is None else y + bias.to(BF16)[:, None, None]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that takes bf16 inputs with ``conv_bf16``."""

    def forward(self, x):
        if x.dtype == BF16:
            return conv_bf16(x, self.weight, self.bias, self.stride,
                             self.padding)
        return super().forward(x)


def conv(cin: int, cout: int, kernel: int, stride: int = 1,
         padding=None) -> nn.Conv2d:
    """Conv2d with symmetric padding ``kernel // 2`` unless given."""
    if padding is None:
        padding = kernel // 2
    return Conv2d(cin, cout, kernel, stride=stride, padding=padding)


def instance_norm_group_width(c: int, w: int) -> int:
    """The JAX package's lane-group factor k (``instance_norm_group_width``):
    its bf16 statistics are taken per group of every k-th column."""
    k = 1
    while c * k % 128 and k < 8 and w % (2 * k) == 0:
        k *= 2
    return k


def _bf16_mean(x: torch.Tensor, dims) -> torch.Tensor:
    """``jnp.mean`` of a bf16 tensor: an fp32 sum divided by the count,
    rounded to bf16."""
    n = 1
    for d in dims:
        n *= x.shape[d]
    return (x.float().sum(dim=dims, keepdim=True) / n).to(BF16)


def instance_norm_bf16(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``instance_norm_stats`` + ``instance_norm_apply``
    on bf16 NCHW ``x``: per lane group (every k-th column) the mean and the
    mean of centred squares in bf16, combined across the k groups in fp32,
    then the mean and scale rounded to bf16 and applied in bf16."""
    b, c, h, w = x.shape
    k = instance_norm_group_width(c, w)
    xr = x.reshape(b, c, h, w // k, k)
    m = _bf16_mean(xr, (2, 3))                          # (b, c, 1, 1, k)
    ctr = xr - m
    v = _bf16_mean(ctr * ctr, (2, 3)).float()
    m32 = m.float()
    mbar = m32.mean(dim=4, keepdim=True)
    var = v.mean(dim=4, keepdim=True) + ((m32 - mbar) ** 2).mean(
        dim=4, keepdim=True)
    scale = torch.rsqrt(var.clamp_min(0.0) + 1e-5)
    return ((xr - mbar.to(BF16)) * scale.to(BF16)).reshape(b, c, h, w)


class InstanceNorm(nn.Module):
    """Per-image, per-channel normalization over (H, W): no affine
    parameters, eps 1e-5, variance from centred squares."""

    def forward(self, x):
        if x.dtype == BF16:
            return instance_norm_bf16(x)
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
        """fp32 arithmetic; a bf16 input is normalised in fp32 and the
        result rounded to bf16 (flax ``BatchNorm(dtype=bfloat16)`` with
        fp32 running statistics)."""
        mul = torch.rsqrt(self.running_var + 1e-5) * self.weight
        y = ((x.float() - self.running_mean[:, None, None])
             * mul[:, None, None] + self.bias[:, None, None])
        return y.to(x.dtype)


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
