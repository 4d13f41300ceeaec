"""RAFT-Stereo test-mode inference in PyTorch.

The counterpart of the JAX package's ``RAFTStereo.forward(...,
test_mode=True)`` with ``corr_implementation="pallas_alt"``,
``gru_backend="fused"`` and ``fused_encoder=False``: plain-convolution
encoders, then per GRU iteration one on-demand correlation lookup
(``ops.corr.corr_lookup``, CUDA kernel ``csrc/alt_corr.cu``), the coarser
GRU levels, and one fused finest-level update (``ops.cuda_gru.gru_update``,
CUDA kernel ``csrc/gru_update.cu``); the mask head and convex upsampling
run once after the loop.  Images and disparities are NHWC at this
interface, as in the JAX package; the encoders run NCHW.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import RAFTStereoConfig, check_supported
from ..device import fp32_numerics, resolve_device
from ..ops.corr import build_corr_state, corr_lookup
from ..ops.cuda_gru import gru_update, pack_update_params
from ..ops.image import coords_grid_x, resize_nchw
from ..ops.upsample import convex_upsample
from .encoders import BasicEncoder, MultiBasicEncoder
from .layers import conv, init_weights
from .update import BasicMultiUpdateBlock


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class RAFTStereo(nn.Module):
    """RAFT-Stereo for inference.

    ``RAFTStereo(config, device="cuda", seed=0)`` builds the model with
    seeded random weights on ``device``; load real weights with
    ``load_state_dict`` (see ``utils.convert``).  Raises
    ``NotImplementedError`` for a config outside this port's path and
    ``RuntimeError`` when ``device`` is CUDA and no GPU is present.

    Predictions are the x-flow from left to right image, i.e. NEGATIVE
    disparities, as in the JAX package."""

    feature_dim = 256

    def __init__(self, config: RAFTStereoConfig = RAFTStereoConfig(),
                 device="cuda", seed: int = 0):
        super().__init__()
        check_supported(config)
        dev = resolve_device(device)
        self.config = config
        cfg = config
        n = cfg.n_gru_layers
        self.cnet = MultiBasicEncoder((cfg.hidden_dims, cfg.hidden_dims),
                                      norm_fn=cfg.context_norm,
                                      downsample=cfg.n_downsample,
                                      num_layers=n)
        self.fnet = BasicEncoder(self.feature_dim, norm_fn="instance",
                                 downsample=cfg.n_downsample)
        self.context_zqr_convs = nn.ModuleList(
            conv(cfg.hidden_dims[i], cfg.hidden_dims[i] * 3, 3)
            for i in range(n))
        self.update_block = BasicMultiUpdateBlock(cfg)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.eval()
        self.to(dev)
        if dev.type == "cuda":
            fp32_numerics()

    @property
    def device(self) -> torch.device:
        return self.fnet.conv1.weight.device

    @torch.inference_mode()
    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                iters: int = 12, flow_init: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) images in [0, 255] -> ``(disp_low, disp_up)``:
        (B, H/f, W/f, 1) and (B, H, W, 1).  ``flow_init`` is an optional
        (B, H/f, W/f, 1) warm start added to the zero initialisation."""
        cfg = self.config
        n, hd = cfg.n_gru_layers, cfg.hidden_dims
        b = image1.shape[0]

        def norm(img):
            return (2.0 * (img.float() / 255.0) - 1.0).permute(0, 3, 1, 2)

        img1, img2 = norm(image1), norm(image2)
        outputs = self.cnet(img1.contiguous())
        fmaps = self.fnet(torch.cat([img1, img2], dim=0).contiguous())
        net = [torch.tanh(o[0]) for o in outputs]
        zqr = [torch.split(c(F.relu(o[1])), hd[i], dim=1)
               for i, (o, c) in enumerate(zip(outputs,
                                              self.context_zqr_convs))]
        state = build_corr_state(_nhwc(fmaps[:b]), _nhwc(fmaps[b:]),
                                 cfg.corr_levels)

        h0 = _nhwc(net[0])
        cz0, cr0, cq0 = (_nhwc(t) for t in zqr[0])
        h_lo, w_lo = h0.shape[1:3]
        disp = torch.zeros((b, h_lo, w_lo, 1), device=h0.device)
        if flow_init is not None:
            disp = disp + flow_init.float()
        grid = coords_grid_x(b, h_lo, w_lo, device=h0.device)[..., 0]
        wpack = pack_update_params(self.update_block,
                                   hd[1] if n > 1 else 0)
        blk = self.update_block
        for _ in range(iters):
            corr = corr_lookup(state, grid + disp[..., 0], cfg.corr_radius)
            ext = None
            if n >= 2:
                net[0] = h0.permute(0, 3, 1, 2)
                blk.update_coarse(net, zqr)
                ext = _nhwc(resize_nchw(net[1], (h_lo, w_lo)))
            h0, delta = gru_update(h0, ext, corr, disp, cz0, cr0, cq0, wpack)
            disp = disp + delta[..., :1]
        mask = _nhwc(blk.upsample_mask(h0.permute(0, 3, 1, 2)))
        return disp, convex_upsample(disp, mask, cfg.factor)
