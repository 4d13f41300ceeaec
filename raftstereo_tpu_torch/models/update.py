"""Iterative refinement: motion encoder, multilevel ConvGRU stack, heads.

Two forms of one GRU iteration, as in the JAX package
(``models/raft_stereo.py`` ``_step_body``):

* the fused step: the finest level's update (motion encoder + gru08 +
  flow head) runs as one kernel, ``ops.cuda_gru.gru_update``, over a
  weight pack of the modules below; the coarser levels run through
  ``update_coarse``;
* the module step (``BasicMultiUpdateBlock.forward``, the JAX
  ``BasicMultiUpdateBlock.__call__``): every level through the modules,
  differentiable; training always takes it.

Everything here is NCHW; levels update coarsest first.  Each module
computes in its input's dtype; bf16 inputs take the JAX package's bf16
forms, rounding where it rounds (``layers.conv_bf16``): the GRU gates as
two convs (h and x), each rounded, summed in bf16, the bias on the x
part, the sigmoid as XLA computes it in bf16 (``sigmoid_bf16``); the
motion encoder's convf1 on the x-flow channel alone.  In training the
bf16 sigmoid and tanh take JAX's differentiation rules
(``ops.cuda_gru``); the convolutions' and the resize's autograd already
follow JAX's transposes."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import RAFTStereoConfig
from ..ops.cuda_gru import sigmoid_bf16, tanh_bf16
from ..ops.image import avg_pool2x, resize_nchw
from .layers import BF16, conv, conv_bf16


def interp_to(x: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """Align-corners bilinear resize of NCHW ``x`` to ``dest``'s H, W."""
    return resize_nchw(x, tuple(dest.shape[2:]))


class ConvGRU(nn.Module):
    """Conv GRU with external context biases; the z and r gates are one
    fused conv (``convzr``) over [h, x]."""

    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.convzr = conv(hidden_dim + input_dim, 2 * hidden_dim, 3)
        self.convq = conv(hidden_dim + input_dim, hidden_dim, 3)

    def forward(self, h, cz, cr, cq, *x_list):
        hd = self.hidden_dim
        x = torch.cat(x_list, dim=1)
        if h.dtype == BF16:
            zr = self._sliced(self.convzr, h, x)
            z = sigmoid_bf16(zr[:, :hd] + cz)
            r = sigmoid_bf16(zr[:, hd:] + cr)
            q = tanh_bf16(self._sliced(self.convq, r * h, x) + cq)
            return (1 - z) * h + z * q
        zr = self.convzr(torch.cat([h, x], dim=1))
        z = torch.sigmoid(zr[:, :hd] + cz)
        r = torch.sigmoid(zr[:, hd:] + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q

    def _sliced(self, m: nn.Conv2d, h, x):
        """The JAX package's two ``_sliced_conv``s in bf16: the conv of h
        and the conv of x (with the bias), each rounded, summed in bf16."""
        hd = self.hidden_dim
        return (conv_bf16(h, m.weight[:, :hd], None, padding=1)
                + conv_bf16(x, m.weight[:, hd:], m.bias, padding=1))


class BasicMotionEncoder(nn.Module):
    """Correlation + flow -> 128 motion channels (126 learned + the 2-channel
    flow).  The fp32 form: convf1 runs on the full [d, 0] flow; the bf16
    form on the x-flow channel alone (the y channel is a structural
    zero), as the JAX package's bf16 form does.  ``preact``: ``corr`` is
    already relu(convc1(corr)), the fused lookup's output."""

    def __init__(self, cor_planes: int):
        super().__init__()
        self.convc1 = conv(cor_planes, 64, 1, padding=0)
        self.convc2 = conv(64, 64, 3)
        self.convf1 = conv(2, 64, 7, padding=3)
        self.convf2 = conv(64, 64, 3)
        self.conv = conv(128, 128 - 2, 3)

    def forward(self, flow, corr, preact: bool = False):
        c1 = corr if preact else F.relu(self.convc1(corr))
        cor = F.relu(self.convc2(c1))
        if flow.dtype == BF16:
            f1 = conv_bf16(flow[:, :1], self.convf1.weight[:, :1],
                           self.convf1.bias, padding=3)
        else:
            f1 = self.convf1(flow)
        flo = F.relu(self.convf2(F.relu(f1)))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class FlowHead(nn.Module):
    """3x3 conv -> relu -> 3x3 conv to 2 channels (channel 0 is used)."""

    def __init__(self, input_dim: int, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = conv(input_dim, hidden_dim, 3)
        self.conv2 = conv(hidden_dim, 2, 3)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicMultiUpdateBlock(nn.Module):
    """Coupled multilevel GRU update.  gru08 is the finest level, gru16 and
    gru32 the coarser ones (built only when ``n_gru_layers`` uses them)."""

    def __init__(self, config: RAFTStereoConfig):
        super().__init__()
        hd, n = config.hidden_dims, config.n_gru_layers
        self.n = n
        self.encoder = BasicMotionEncoder(config.cor_planes)
        self.gru08 = ConvGRU(hd[0], 128 + (hd[1] if n > 1 else 0))
        if n >= 2:
            self.gru16 = ConvGRU(hd[1], hd[0] + (hd[2] if n > 2 else 0))
        if n == 3:
            self.gru32 = ConvGRU(hd[2], hd[1])
        self.flow_head = FlowHead(hd[0], 256)
        f = config.factor
        self.mask = nn.Sequential(conv(hd[0], 256, 3), nn.ReLU(),
                                  conv(256, f * f * 9, 1, padding=0))

    def update_coarse(self, net: List[torch.Tensor], zqr: Sequence) -> None:
        """Advance the coarser levels in place (NCHW ``net``), coarsest
        first, from the current finer states."""
        if self.n == 3:
            net[2] = self.gru32(net[2], *zqr[2], avg_pool2x(net[1]))
        xs = [avg_pool2x(net[0])]
        if self.n == 3:
            xs.append(interp_to(net[2], net[1]))
        net[1] = self.gru16(net[1], *zqr[1], *xs)

    def forward(self, net: List[torch.Tensor], zqr: Sequence,
                corr: torch.Tensor, flow: torch.Tensor,
                corr_preact: bool = False
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """The module step: coarser levels, then the motion encoder on
        (flow, corr), gru08 with the upsampled next level, and the flow
        head.  Returns the new states and the 2-channel delta (NCHW).
        ``corr_preact``: ``corr`` is the fused lookup's relu(convc1(.))."""
        net = list(net)
        if self.n >= 2:
            self.update_coarse(net, zqr)
        xs = [self.encoder(flow, corr, corr_preact)]
        if self.n >= 2:
            xs.append(interp_to(net[1], net[0]))
        net[0] = self.gru08(net[0], *zqr[0], *xs)
        return net, self.flow_head(net[0])

    def upsample_mask(self, net0: torch.Tensor) -> torch.Tensor:
        """Convex-upsampling mask from the finest state (NCHW), scaled by
        0.25 as in the reference."""
        return 0.25 * self.mask(net0)
