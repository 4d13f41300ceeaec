"""Image-space primitives, NHWC like the JAX package's ``ops/image.py``.

* ``resize_bilinear_align_corners``: separable gather + lerp with
  align-corners geometry (rows first, then columns, as the JAX op does);
* ``avg_pool2x``: 3x3 / stride 2 / pad 1 average pool, zeros counted;
* ``InputPadder`` / ``BucketPadder``: replicate padding to ``divis_by``
  and the bucket grid, the shape policy the serving engine uses;
* ``coords_grid_x``: the x-coordinate grid at disparity resolution.

The resize and the pool take fp32 or bf16 tensors; a bf16 tensor follows
the JAX ops' rounding points (see each function).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _axis_resize_indices(in_size: int, out_size: int):
    """Source indices + lerp weight for an align-corners resize along one
    axis (the JAX package's float64 positions, fp32 weights)."""
    if out_size == 1 or in_size == 1:
        idx = np.zeros((out_size,), np.int64)
        return idx, idx, np.zeros((out_size,), np.float32)
    pos = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    i0 = np.minimum(np.floor(pos).astype(np.int64), in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    return i0, i1, (pos - i0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _resize_tables(in_size: int, out_size: int, device: torch.device):
    """Device copies of ``_axis_resize_indices``, built once per shape: the
    GRU loop resizes at the same shapes every iteration, and a host copy
    per call stalls the stream.  Callers only read them.  Built outside
    inference mode, so a table first made while serving can still be
    saved for a training backward."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device)
                     for a in _axis_resize_indices(in_size, out_size))


def resize_bilinear_align_corners(x: torch.Tensor,
                                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=True of (B, H, W, C) to
    ``out_hw``."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    if x.dtype == torch.bfloat16:
        return _resize_bf16(x, out_hw)
    i0, i1, wh = _resize_tables(h, oh, x.device)
    wh = wh[None, :, None, None]
    x = x[:, i0] * (1 - wh) + x[:, i1] * wh
    j0, j1, ww = _resize_tables(w, ow, x.device)
    ww = ww[None, None, :, None]
    return x[:, :, j0] * (1 - ww) + x[:, :, j1] * ww


def _resize_bf16(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """The JAX op on a bf16 tensor, as its code computes it: the weights
    are rounded to bf16, ``1 - w`` is an fp32 array (numpy promotes it), so
    the row pass is ``x0 * (1 - w)`` in fp32 plus ``x1 * w`` rounded to
    bf16, the column pass runs in fp32, and the result is rounded once."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    i0, i1, wh = _resize_tables(h, oh, x.device)
    j0, j1, ww = _resize_tables(w, ow, x.device)
    wh = wh.to(torch.bfloat16)[None, :, None, None]
    ww = ww.to(torch.bfloat16).float()[None, None, :, None]
    y = x[:, i0].float() * (1 - wh.float()) + (x[:, i1] * wh).float()
    y = y[:, :, j0] * (1 - ww) + y[:, :, j1] * ww
    return y.to(torch.bfloat16)


def resize_nchw(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``resize_bilinear_align_corners`` for an NCHW tensor."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    return resize_bilinear_align_corners(
        x.permute(0, 2, 3, 1), out_hw).permute(0, 3, 1, 2)


def avg_pool2x(x: torch.Tensor) -> torch.Tensor:
    """3x3/stride-2/pad-1 average pool of an NCHW tensor, zeros counted in
    the divisor (``count_include_pad``).  A bf16 tensor is pooled as the
    JAX op's ``reduce_window`` sums it: the nine taps added in bf16 in
    row-major window order, then divided by 9 in bf16."""
    if x.dtype != torch.bfloat16:
        return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)
    h, w = x.shape[2:]
    oh, ow = (h + 1) // 2, (w + 1) // 2
    p = F.pad(x, (1, 1, 1, 1))
    s = None
    for dy in range(3):
        for dx in range(3):
            t = p[:, :, dy:dy + 2 * oh - 1:2, dx:dx + 2 * ow - 1:2]
            s = t if s is None else s + t
    # A tensor divisor: division by a Python scalar may become a multiply
    # by its reciprocal.
    return s / torch.full((), 9.0, dtype=s.dtype, device=s.device)


def replicate_pad(x: torch.Tensor, pad: Sequence[int]) -> torch.Tensor:
    """Edge-replicate pad of (B, H, W, C); pad = (left, right, top,
    bottom).  Index gathers, so padded values are exact copies."""
    l, r, t, bt = pad
    if not any(pad):
        return x
    h, w = x.shape[1:3]
    rows = torch.arange(-t, h + bt, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-l, w + r, device=x.device).clamp(0, w - 1)
    return x[:, rows][:, :, cols]


class InputPadder:
    """Pads NHWC images so H and W are divisible by ``divis_by``; 'sintel'
    mode splits the padding around the image, otherwise all height
    padding goes to the bottom."""

    def __init__(self, dims: Sequence[int], mode: str = "sintel",
                 divis_by: int = 8):
        self.ht, self.wd = dims[-3:-1] if len(dims) == 4 else dims[-2:]
        pad_ht = (((self.ht // divis_by) + 1) * divis_by - self.ht) % divis_by
        pad_wd = (((self.wd // divis_by) + 1) * divis_by - self.wd) % divis_by
        if mode == "sintel":
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2)
        else:
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht)

    @property
    def padded_hw(self) -> Tuple[int, int]:
        l, r, t, b = self._pad
        return self.ht + t + b, self.wd + l + r

    def pad(self, *inputs: torch.Tensor):
        out = [replicate_pad(x, self._pad) for x in inputs]
        return out if len(out) > 1 else out[0]

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        l, r, t, b = self._pad
        ht, wd = x.shape[1:3]
        return x[:, t:ht - b, l:wd - r, :]


class BucketPadder:
    """``InputPadder`` alignment to ``divis_by``, then a round-up of the
    padded shape to the ``bucket_multiple`` grid with edge-replicate
    rows/columns on the bottom/right.  ``dims`` may be (H, W), (H, W, C)
    or (B, H, W, C)."""

    def __init__(self, dims: Sequence[int], divis_by: int = 32,
                 bucket_multiple: Optional[int] = None, mode: str = "sintel"):
        if len(dims) == 3:
            hw: Sequence[int] = dims[:2]
        elif len(dims) == 4:
            hw = dims[1:3]
        else:
            hw = dims
        self._padder = InputPadder(hw, mode=mode, divis_by=divis_by)
        ph, pw = self._padder.padded_hw
        m = bucket_multiple or 1
        self.extra_h = (-ph) % m
        self.extra_w = (-pw) % m
        self.bucket_hw: Tuple[int, int] = (ph + self.extra_h,
                                           pw + self.extra_w)

    def pad(self, *inputs: torch.Tensor):
        out = [replicate_pad(self._padder.pad(x),
                             (0, self.extra_w, 0, self.extra_h))
               for x in inputs]
        return out if len(out) > 1 else out[0]

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, :x.shape[1] - self.extra_h, :x.shape[2] - self.extra_w, :]
        return self._padder.unpad(x)


def coords_grid_x(batch: int, ht: int, wd: int,
                  device="cpu") -> torch.Tensor:
    """x-coordinate grid (B, H, W, 1), float32: stereo carries x only."""
    x = torch.arange(wd, dtype=torch.float32, device=device)
    return x[None, None, :, None].expand(batch, ht, wd, 1)
