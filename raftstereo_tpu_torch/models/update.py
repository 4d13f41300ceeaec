"""Iterative refinement: motion encoder, multilevel ConvGRU stack, heads.

The finest level's update (motion encoder + gru08 + flow head) runs as
one fused step, ``ops.cuda_gru.gru_update``, over a weight pack of the
modules below; the coarser levels run through ``ConvGRU`` here, NCHW,
coarsest first, as in the JAX package's fused-step branch
(``models/raft_stereo.py`` ``_step_body``)."""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from ..config import RAFTStereoConfig
from ..ops.image import avg_pool2x, resize_nchw
from .layers import conv


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
        zr = self.convzr(torch.cat([h, x], dim=1))
        z = torch.sigmoid(zr[:, :hd] + cz)
        r = torch.sigmoid(zr[:, hd:] + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    """Correlation + flow -> 128 motion channels (126 learned + the 2-channel
    flow).  Its weights run inside the fused update."""

    def __init__(self, cor_planes: int):
        super().__init__()
        self.convc1 = conv(cor_planes, 64, 1, padding=0)
        self.convc2 = conv(64, 64, 3)
        self.convf1 = conv(2, 64, 7, padding=3)
        self.convf2 = conv(64, 64, 3)
        self.conv = conv(128, 128 - 2, 3)


class FlowHead(nn.Module):
    """3x3 conv -> relu -> 3x3 conv to 2 channels (channel 0 is used)."""

    def __init__(self, input_dim: int, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = conv(input_dim, hidden_dim, 3)
        self.conv2 = conv(hidden_dim, 2, 3)


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

    def upsample_mask(self, net0: torch.Tensor) -> torch.Tensor:
        """Convex-upsampling mask from the finest state (NCHW), scaled by
        0.25 as in the reference."""
        return 0.25 * self.mask(net0)
