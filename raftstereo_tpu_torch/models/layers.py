"""Building blocks: norms, convs and residual blocks (NCHW inside the
model; the JAX package's ``models/layers.py`` is the reference).

Each block computes in its input's dtype.  fp32 inputs take the fp32
arithmetic as before.  bf16 inputs follow flax's ``dtype=bfloat16``
modules: parameters stay fp32 and are cast at use, a convolution's output
is rounded to bf16 before its bias is added in bf16, batch norm computes
in fp32 and rounds once, and instance norm keeps the JAX package's
``instance_norm_stats`` rounding points.  In training the bias add and
instance norm take the VJPs of JAX's transposes (``ops/bf16.py``'s
``conv_bf16``, ``_InstanceNormBf16``), whose bf16 sums over an image are
``bf16.sum32``."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import bf16
from ..ops.bf16 import BF16, conv_bf16


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


class _InstanceNormBf16(torch.autograd.Function):
    """The JAX package's ``instance_norm_stats`` + ``instance_norm_apply``
    on bf16 NCHW ``x``, with the VJP that JAX's transposes of those ops
    give, rounding point for rounding point: the normalised tensor's
    cotangent through the bf16 products, the statistics' cotangents
    through the fp32 group arithmetic (rsqrt, max, the k-group means) and
    back through the bf16 casts, the centred squares and the group means.
    Its bf16 sums over the image (three of them) accumulate in fp32 and
    round once, as on an accelerator (XLA:CPU rounds every add of such a
    sum in bf16)."""

    @staticmethod
    def forward(ctx, x):
        b, c, h, w = x.shape
        k = instance_norm_group_width(c, w)
        xr = x.reshape(b, c, h, w // k, k)
        m = _bf16_mean(xr, (2, 3))                      # (b, c, 1, 1, k)
        ctr = xr - m
        v = _bf16_mean(ctr * ctr, (2, 3)).float()
        m32 = m.float()
        mbar = m32.mean(dim=4, keepdim=True)
        var = v.mean(dim=4, keepdim=True) + ((m32 - mbar) ** 2).mean(
            dim=4, keepdim=True)
        varc = var.clamp_min(0.0)
        eps = varc + 1e-5
        scale = torch.rsqrt(eps)
        mw, sw = mbar.to(BF16), scale.to(BF16)
        bz = xr - mw
        ctx.save_for_backward(bz, ctr * 2, m32 - mbar, var, varc, eps, scale,
                              sw)
        ctx.k, ctx.n = k, h * (w // k)
        return (bz * sw).reshape(b, c, h, w)

    @staticmethod
    def backward(ctx, dy):
        bz, ctr2, dm32, var, varc, eps, scale, sw = ctx.saved_tensors
        k = ctx.k
        kf = torch.full((), float(k), device=dy.device)
        nf = torch.full((), float(ctx.n), device=dy.device)
        dyr = dy.reshape(bz.shape)
        cf = dyr * sw                                     # the sweep's
        d_scale = bf16.sum32(bz * dyr, (2, 3)).float().sum(dim=4,
                                                           keepdim=True)
        d_mbar = bf16.sum32(-cf, (2, 3)).float().sum(dim=4, keepdim=True)
        # rsqrt, then max(var, 0): slope 1 above 0, 1/2 at 0, 0 below
        d_var = d_scale * (-0.5 * (scale / eps))
        d_var = d_var * (torch.where(var == varc, 1.0, 0.0)
                         / torch.where(varc == 0, 2.0, 1.0))
        cy = (d_var / kf) * (2 * dm32)                    # via (m_g - mbar)^2
        d_mbar = d_mbar + (-cy).sum(dim=4, keepdim=True)
        d_m32 = cy + d_mbar / kf                          # (b, c, 1, 1, k)
        d_v = (d_var / kf).to(BF16).float() / nf          # via v's mean
        ds = d_v.to(BF16) * ctr2                          # via ctr * ctr
        d_m = d_m32.to(BF16) + bf16.sum32(-ds, (2, 3))
        ec = (d_m.float() / nf).to(BF16)                  # via m's mean
        # JAX adds the three in the order its transposes reach x: the
        # group view is a separate array for k > 1, x itself for k = 1.
        dx = cf + (ds + ec) if k > 1 else (cf + ds) + ec
        return dx.reshape(dy.shape)


def instance_norm_bf16(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``instance_norm_stats`` + ``instance_norm_apply``
    on bf16 NCHW ``x``: per lane group (every k-th column) the mean and the
    mean of centred squares in bf16, combined across the k groups in fp32,
    then the mean and scale rounded to bf16 and applied in bf16;
    differentiated as JAX differentiates it (``_InstanceNormBf16``)."""
    return _InstanceNormBf16.apply(x)


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
