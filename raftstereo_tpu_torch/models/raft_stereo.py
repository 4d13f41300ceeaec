"""RAFT-Stereo in PyTorch: test-mode inference and train mode.

The counterpart of the JAX package's ``RAFTStereo.forward``: the
encoders, the correlation state of the resolved backend once per pair
(``ops.corr.build_corr_state``), then per GRU iteration one correlation
lookup (``ops.corr.corr_lookup``) and one update of the GRU levels.

* ``corr_implementation`` "auto" or "pallas_alt": the on-demand lookup
  (CUDA kernels ``csrc/alt_corr.cu`` forward, ``csrc/alt_corr_bwd.cu``
  backward).  "pallas": the fp32 volume and its pyramid, then the volume
  lookup (``csrc/corr_vol.cu``, ``csrc/corr_vol_bwd.cu``).  "reg", "alt":
  the JAX package's XLA lookups in plain PyTorch.  ``corr_quant`` in test
  mode: the int8 volume (``csrc/int8_volume.cu``) and the "pallas"
  lookup; train mode builds the unquantized state of the configured
  backend whatever the flag says, as the JAX package does.  With
  ``corr_dtype="bfloat16"`` the "pallas" volume pyramid (and the int8
  volume) is stored in bf16 and looked up by the kernel's bf16 form; in
  train mode the lookup's fp32 backward is cast to the bf16 volume.

* ``fused_encoder`` None or False: plain-convolution encoders (the JAX
  package's ``fused_encoder=False`` path).  True: both encoders run their
  stem + layer1 and layer2 through the fused stages
  (``ops.encoder_stage``, CUDA kernels ``csrc/enc_conv_tc.cu``,
  ``enc_conv.cu``, ``enc_stats.cu``, ``enc_finish.cu``); in train mode
  their backward is
  the JAX package's hand-written one (``ops.encoder_bwd``, with the
  instance-norm backward's sums as ``enc_stats.cu``'s second kernel), in
  the compute dtype.

* Test mode with ``gru_backend`` "auto" or "fused": the coarser levels,
  then one fused finest-level update (``ops.cuda_gru.gru_update``, CUDA
  kernel ``csrc/gru_update.cu``); the mask head and convex upsampling run
  once after the loop.
* Test mode with "xla", and train mode always: the module step
  (``BasicMultiUpdateBlock.forward``).  Train mode detaches the disparity
  at the start of every iteration, upsamples each iteration's prediction
  with that iteration's mask, and with ``remat`` recomputes each
  iteration in the backward pass (``torch.utils.checkpoint``).

* ``compute_dtype="bfloat16"`` (the JAX package's ``--mixed_precision``,
  test and train mode): the images are normalised in fp32 and cast, the
  encoders and GRUs run in bf16 (fp32 parameters cast at use, as flax
  does), the disparity stays fp32 and each delta is cast to fp32, and the
  mask is cast to fp32 before the convex upsampling.  In test mode the
  fused step takes the bf16 forms of the lookup and update kernels; the
  module step of ``pallas_alt`` takes the lookup with convc1 fused in
  (``ops.cuda_alt.alt_corr_epi``), the JAX package's ``use_epi`` gate.
  In train mode the module step runs with the differentiable lookup (its
  backward's bf16 form for bf16 feature maps), and gradients reach the
  fp32 parameters through the casts, as in the JAX package.

Images and disparities are NHWC at this interface, as in the JAX package;
the encoders and GRUs run NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import RAFTStereoConfig, check_supported
from ..device import fp32_numerics, resolve_device
from ..ops.corr import build_corr_state, corr_lookup, corr_lookup_epi
from ..ops.cuda_gru import gru_update, pack_update_params, tanh_bf16
from ..ops.image import coords_grid_x, resize_nchw
from ..ops.upsample import convex_upsample
from .encoders import BasicEncoder, MultiBasicEncoder
from .layers import conv, init_weights
from .update import BasicMultiUpdateBlock


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class RAFTStereo(nn.Module):
    """RAFT-Stereo for inference and training.

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
        cfg = config
        n = cfg.n_gru_layers
        self.cnet = MultiBasicEncoder((cfg.hidden_dims, cfg.hidden_dims),
                                      norm_fn=cfg.context_norm,
                                      downsample=cfg.n_downsample,
                                      num_layers=n,
                                      fused_stem=cfg.fused_encoder)
        self.fnet = BasicEncoder(self.feature_dim, norm_fn="instance",
                                 downsample=cfg.n_downsample,
                                 fused_stem=cfg.fused_encoder)
        self.context_zqr_convs = nn.ModuleList(
            conv(cfg.hidden_dims[i], cfg.hidden_dims[i] * 3, 3)
            for i in range(n))
        self.update_block = BasicMultiUpdateBlock(cfg)
        self._set_numerics(cfg)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.eval()
        self.to(dev)
        if dev.type == "cuda":
            fp32_numerics()

    def with_numerics(self, config: RAFTStereoConfig) -> "RAFTStereo":
        """A model of ``config``, which may differ from this model's config
        only in ``compute_dtype``, ``corr_dtype`` and ``corr_quant`` (an
        accuracy tier's), sharing this model's submodules and parameter
        tensors: nothing is copied, and a weight loaded into one is the
        other's.  Raises ``NotImplementedError`` for numerics the port does
        not run."""
        numerics = dict(compute_dtype=self.config.compute_dtype,
                        corr_dtype=self.config.corr_dtype,
                        corr_quant=self.config.corr_quant)
        if dataclasses.replace(config, **numerics) != self.config:
            raise ValueError(f"{config} differs from {self.config} beyond "
                             f"its numerics")
        check_supported(config)
        twin = RAFTStereo.__new__(RAFTStereo)
        nn.Module.__init__(twin)
        for name, module in self.named_children():
            setattr(twin, name, module)
        twin._set_numerics(config)
        twin.training = self.training
        return twin

    def _set_numerics(self, config: RAFTStereoConfig) -> None:
        self.config = config
        # Parameters stay fp32 whatever the compute dtype: the bf16 forms
        # cast them at use, as flax's dtype=bfloat16 modules do.
        self.dtype = (torch.bfloat16 if config.compute_dtype == "bfloat16"
                      else torch.float32)
        self.corr_dtype = (torch.bfloat16 if config.corr_dtype == "bfloat16"
                           else torch.float32)
        self._wpack = (None, None)  # (key, pack): see _update_pack

    @property
    def device(self) -> torch.device:
        return self.fnet.conv1.weight.device

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                iters: int = 12, flow_init: Optional[torch.Tensor] = None,
                test_mode: bool = True):
        """(B, H, W, 3) images in [0, 255].

        ``test_mode=True`` (the default, under ``torch.inference_mode``):
        returns ``(disp_low, disp_up)``, (B, H/f, W/f, 1) and (B, H, W, 1).
        ``test_mode=False`` (training): returns every iteration's
        full-resolution prediction, (iters, B, H, W, 1), differentiable.
        ``flow_init`` is an optional (B, H/f, W/f, 1) warm start added to
        the zero initialisation."""
        if test_mode:
            with torch.inference_mode():
                return self._forward(image1, image2, iters, flow_init, True)
        return self._forward(image1, image2, iters, flow_init, False)

    def _forward(self, image1, image2, iters, flow_init, test_mode):
        cfg = self.config
        n, hd = cfg.n_gru_layers, cfg.hidden_dims
        b = image1.shape[0]

        def norm(img):
            return (2.0 * (img.float() / 255.0) - 1.0).to(
                self.dtype).permute(0, 3, 1, 2)

        img1, img2 = norm(image1), norm(image2)
        outputs = self.cnet(img1.contiguous())
        fmaps = self.fnet(torch.cat([img1, img2], dim=0).contiguous())
        tanh = tanh_bf16 if self.dtype == torch.bfloat16 else torch.tanh
        net = [tanh(o[0]) for o in outputs]
        zqr = [torch.split(c(F.relu(o[1])), hd[i], dim=1)
               for i, (o, c) in enumerate(zip(outputs,
                                              self.context_zqr_convs))]
        # The int8 volume is inference-only: its rounding defines no useful
        # gradient, so train mode builds the unquantized state.
        quant = cfg.corr_quant and test_mode
        state = build_corr_state(_nhwc(fmaps[:b]), _nhwc(fmaps[b:]),
                                 cfg.corr_levels, cfg.corr_implementation,
                                 quant, self.corr_dtype)
        h_lo, w_lo = net[0].shape[2:]
        disp = torch.zeros((b, h_lo, w_lo, 1), device=net[0].device)
        if flow_init is not None:
            disp = disp + flow_init.float()
        grid = coords_grid_x(b, h_lo, w_lo, device=disp.device)[..., 0]
        blk = self.update_block
        dtype = self.dtype

        if test_mode and cfg.gru_backend != "xla":
            return self._fused_loop(state, net, zqr, disp, grid, iters)

        # bf16 test mode fuses the motion encoder's convc1 into the lookup
        # where the backend can (the JAX package's use_epi gate).
        epi = None
        if (test_mode and dtype == torch.bfloat16
                and state.backend == "pallas_alt"):
            c1 = blk.encoder.convc1
            epi = (c1.weight[:, :, 0, 0].t().to(dtype).contiguous(),
                   c1.bias.to(dtype).contiguous())

        def step(disp, *net):
            """One module-step iteration (NCHW states, NHWC disparity);
            train mode also returns this iteration's upsampled
            prediction."""
            disp = disp.detach()
            x = grid + disp[..., 0]
            if epi is None:
                corr = corr_lookup(state, x, cfg.corr_radius, dtype)
            else:
                corr = corr_lookup_epi(state, x, cfg.corr_radius, *epi)
            flow = torch.cat([disp, torch.zeros_like(disp)], dim=-1)
            net, delta = blk(net, zqr, corr.permute(0, 3, 1, 2),
                             flow.to(dtype).permute(0, 3, 1, 2),
                             corr_preact=epi is not None)
            disp = disp + _nhwc(delta[:, :1]).float()
            if test_mode:
                return (disp, *net)
            mask = _nhwc(blk.upsample_mask(net[0]))
            return (disp, *net, convex_upsample(disp, mask, cfg.factor))

        preds = []
        for _ in range(iters):
            if cfg.remat and not test_mode:
                out = checkpoint(step, disp, *net, use_reentrant=False)
            else:
                out = step(disp, *net)
            disp, net = out[0], list(out[1:1 + n])
            if not test_mode:
                preds.append(out[-1])
        if not test_mode:
            return torch.stack(preds)
        mask = _nhwc(blk.upsample_mask(net[0])).float()
        return disp, convex_upsample(disp, mask, cfg.factor)

    def _update_pack(self, ext_dim: int):
        """The fused update's weight pack, built once and rebuilt only when
        a parameter of the update block moved or changed in place (an
        optimizer step or ``load_state_dict`` bumps its version)."""
        key = (self.dtype, ext_dim) + tuple(
            (p.data_ptr(), p._version) for p in self.update_block.parameters())
        if self._wpack[0] != key:
            self._wpack = (key, pack_update_params(self.update_block, ext_dim,
                                                   self.dtype))
        return self._wpack[1]

    def _fused_loop(self, state, net, zqr, disp, grid, iters):
        """Test-mode iterations through the fused finest-level update
        kernel; the mask head runs once after the loop."""
        cfg = self.config
        n, hd = cfg.n_gru_layers, cfg.hidden_dims
        h0 = _nhwc(net[0])
        cz0, cr0, cq0 = (_nhwc(t) for t in zqr[0])
        h_lo, w_lo = h0.shape[1:3]
        wpack = self._update_pack(hd[1] if n > 1 else 0)
        blk = self.update_block
        for _ in range(iters):
            corr = corr_lookup(state, grid + disp[..., 0], cfg.corr_radius,
                               self.dtype)
            ext = None
            if n >= 2:
                net[0] = h0.permute(0, 3, 1, 2)
                blk.update_coarse(net, zqr)
                ext = _nhwc(resize_nchw(net[1], (h_lo, w_lo)))
            h0, delta = gru_update(h0, ext, corr, disp, cz0, cr0, cq0, wpack)
            disp = disp + delta[..., :1].float()
        mask = _nhwc(blk.upsample_mask(h0.permute(0, 3, 1, 2))).float()
        return disp, convex_upsample(disp, mask, cfg.factor)
