"""Feature and context encoders.  Module names follow the upstream
PyTorch RAFT-Stereo so the weight bridge maps one to one.

``fused_stem=True`` (``config.fused_encoder``) runs the stem + layer1 and
layer2 through the fused stages (``ops.encoder_stage``, CUDA kernels
``csrc/enc_*.cu``, with the JAX package's hand-written backward); otherwise
the plain convolutions and norms run (the JAX package's ``_plain_stem``
path).  Both compute in the input's dtype: a bf16 image (``compute_dtype=
"bfloat16"``) takes the fused stages' bf16 kernels and, in training, their
bf16 backward, as the JAX package's fused stages take ``dt=bfloat16``.
In training, gradients reach the frozen batch norms' weight and
bias through ``encoder_stage.bn_affine``; their running statistics are
buffers and get none."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch.nn as nn
import torch.nn.functional as F

from ..ops import encoder_stage as es
from .layers import ResidualBlock, conv, make_norm


def _trunk(enc, norm_fn: str, downsample: int) -> None:
    """conv1 -> norm1 -> layer1..layer3, strides from ``downsample``."""
    d = downsample
    enc.norm_fn = norm_fn
    enc.conv1 = conv(3, 64, 7, stride=1 + (d > 2), padding=3)
    enc.norm1 = make_norm(norm_fn, 64)
    enc.layer1 = nn.Sequential(ResidualBlock(64, 64, norm_fn),
                               ResidualBlock(64, 64, norm_fn))
    enc.layer2 = nn.Sequential(ResidualBlock(64, 96, norm_fn, 1 + (d > 1)),
                               ResidualBlock(96, 96, norm_fn))
    enc.layer3 = nn.Sequential(ResidualBlock(96, 128, norm_fn, 1 + (d > 0)),
                               ResidualBlock(128, 128, norm_fn))


def _wb(m: nn.Conv2d):
    return m.weight, m.bias


def _bn(norms) -> list:
    return [es.bn_affine(m.weight, m.bias, m.running_mean, m.running_var)
            for m in norms]


# The dispatch below is the JAX package's ``_stem_layer1`` and
# ``_trunk_layer2`` (raftstereo_tpu/models/encoders.py:26-144) with the
# gate forced on, branch for branch.  The geometry conditions (even output
# width, <= 4 images for the fused conv1, >= 3 output rows, H % 2 and
# W % 4 for the stride-2 conv1, even H and W for layer2) exist for the TPU
# kernels' layouts, not for these kernels; they are kept so that the same
# config and shape take the same function in both packages.
def _stem_layer1(enc, x):
    """conv1 + norm1 + relu + layer1 of the NCHW image."""
    stride = enc.conv1.stride[0]
    b, c, h, w = x.shape
    h_out, w_out = -(-h // stride), -(-w // stride)
    if not (enc.fused_stem is True and enc.norm_fn in ("instance", "batch")
            and w_out % 2 == 0):
        x = F.relu(enc.norm1(enc.conv1(x)))
        return enc.layer1(x)
    l0, l1 = enc.layer1
    params = {"c10": _wb(l0.conv1), "c11": _wb(l0.conv2),
              "c20": _wb(l1.conv1), "c21": _wb(l1.conv2)}
    affines = None
    if enc.norm_fn == "batch":
        affines = _bn((enc.norm1, l0.norm1, l0.norm2, l1.norm1, l1.norm2))
    ok_geom = (c == 3 and b <= 4 and h_out >= 3
               and (stride == 1 or (h % 2 == 0 and w % 4 == 0)))
    if ok_geom:
        if affines is not None:
            return es.bn_conv1_stem_layer1(x, _wb(enc.conv1), params,
                                           affines, stride)
        return es.conv1_stem_layer1(x, _wb(enc.conv1), params, stride)
    if affines is not None:
        return es.bn_stem_layer1(enc.conv1(x), params, affines)
    return es.stem_layer1(enc.conv1(x), params)


def _trunk_layer2(enc, x):
    """layer2: two ResidualBlocks, the first stride 2 with a projection."""
    l0, l1 = enc.layer2
    _, _, h, w = x.shape
    if not (enc.fused_stem is True and enc.norm_fn in ("instance", "batch")
            and l0.conv1.stride[0] == 2 and h % 2 == 0 and w % 2 == 0):
        return enc.layer2(x)
    params = {"c1": _wb(l0.conv1), "c2": _wb(l0.conv2),
              "proj": _wb(l0.downsample[0]), "c3": _wb(l1.conv1),
              "c4": _wb(l1.conv2)}
    if enc.norm_fn == "batch":
        return es.fused_layer2_bn(x, params, _bn(
            (l0.norm1, l0.downsample[1], l0.norm2, l1.norm1, l1.norm2)))
    return es.fused_layer2(x, params)


def _run_trunk(enc, x):
    return enc.layer3(_trunk_layer2(enc, _stem_layer1(enc, x)))


class BasicEncoder(nn.Module):
    """Residual trunk -> ``output_dim`` feature maps at 1/2^downsample."""

    def __init__(self, output_dim: int = 256, norm_fn: str = "instance",
                 downsample: int = 2, fused_stem: Optional[bool] = None):
        super().__init__()
        self.fused_stem = fused_stem
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
                 num_layers: int = 3, fused_stem: Optional[bool] = None):
        super().__init__()
        self.num_layers = num_layers
        self.fused_stem = fused_stem
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
