"""bf16 arithmetic shared by the model's modules and the fused encoder
stages' backward: flax's ``dtype=bfloat16`` convolution and the bf16
sums over an image that JAX's transposes take.

A convolution's output is rounded to bf16 before its fp32 bias, cast to
bf16 at use, is added in bf16; in training the bias's cotangent is the
bf16 sum of ``dy`` over the batch and pixels (``sum32``), widened to
fp32 through the cast."""

from __future__ import annotations

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16


def sum32(x: torch.Tensor, dims) -> torch.Tensor:
    """A bf16 sum over ``dims`` accumulated in fp32 and rounded once (the
    bf16 sums of the JAX package's transposes, as an accelerator takes
    them; XLA:CPU instead rounds every add)."""
    return x.float().sum(dim=dims, keepdim=True).to(BF16)


class BiasAddBf16(torch.autograd.Function):
    """``y + bias`` in bf16 for NCHW ``y`` and an fp32 ``bias`` cast at
    use, as flax adds it: the bias's cotangent is the bf16 sum of ``dy``
    over the batch and pixels (``sum32``), then widened to fp32 through
    the cast."""

    @staticmethod
    def forward(ctx, y, bias):
        return y + bias.to(BF16)[:, None, None]

    @staticmethod
    def backward(ctx, dy):
        return dy, sum32(dy, (0, 2, 3)).reshape(-1).float()


def conv_bf16(x: torch.Tensor, weight: torch.Tensor, bias, stride=1,
              padding=0) -> torch.Tensor:
    """flax ``nn.Conv(dtype=bfloat16)``: input and kernel in bf16, the
    product rounded to bf16 (fp32 accumulation inside), then the bias
    added in bf16 -- one rounding more than ``F.conv2d(x, w, b)``."""
    y = F.conv2d(x.to(BF16), weight.to(BF16), None, stride, padding)
    return y if bias is None else BiasAddBf16.apply(y, bias)
