"""Precomputed-volume correlation lookup: the CUDA kernels
``csrc/corr_vol.cu`` (forward) and ``csrc/corr_vol_bwd.cu`` (its VJP with
respect to the volume), their plain PyTorch versions, and the
``torch.autograd.Function`` that joins the two.

Replaces the TPU kernels ``raftstereo_tpu/ops/pallas_corr.py``
``_lookup_kernel`` and ``_lookup_bwd_kernel`` (the ``pallas`` backend).
The function, for each pixel, level l and tap k with level-0 coordinate
x and t = x * 2^-l + (k - r): the hat-weighted sum over the level's real
columns j of vol_l[j] * max(0, 1 - |j - t|), which is a two-tap lerp,
zero outside [0, w_l - 1]; NaN coordinates give NaN.  The backward writes
the dense gradient volume, dvol_l[j] = sum_k g_k * max(0, 1 - |j - t_k|)
in ascending k, so a NaN coordinate or a non-finite cotangent poisons the
pixel's whole level segment, as the TPU's dense form does.

The bounds on an H100 and what the kernels' designs do about them are in
the sources' notes: both bound by bytes (the forward about 11 MB per call
at the serving shape, the backward about 129 MB at the training shape);
the forward reads only the two weighted columns of each tap, the
backward streams each pixel run's outputs once with no atomics: +0
outside each clean level's window of taps, which needs no arithmetic,
and the K-term sum inside it.

``vol_lookup`` and ``vol_lookup_backward`` run the plain version for CPU
tensors and the kernel for CUDA tensors; they never fall back from one
to the other.  ``vol_lookup_autograd`` is the differentiable lookup.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build


def level_taps(x: torch.Tensor, lvl: int, radius: int) -> torch.Tensor:
    """The 2r+1 taps of level ``lvl`` (B, H, W1, K): x * 2^-l (exact),
    then one float add per tap offset, as the JAX package forms them."""
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32,
                        device=x.device)
    return (x.float() * (1.0 / 2.0 ** lvl))[..., None] + offs


def vol_lookup_plain(vcat: torch.Tensor, widths: Sequence[int],
                     x: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain PyTorch version: per level and tap, the two columns
    floor(t) and floor(t)+1 weighted by their hat values 1 - |j - t| —
    the kernel's arithmetic, each product and the sum rounded once.
    vcat (B, H, W1, sum(widths)), x (B, H, W1) -> (B, H, W1, L*(2r+1))."""
    zero = torch.zeros((), device=x.device)
    cols, off = [], 0
    for lvl, w in enumerate(widths):
        t = level_taps(x, lvl, radius)
        if w == 0:
            cols.append(torch.zeros_like(t))
            continue
        vl = vcat[..., off:off + w]
        f0 = torch.floor(t)
        out = None
        for j in (f0, f0 + 1.0):
            valid = (j >= 0) & (j <= w - 1)  # False for NaN
            v = torch.gather(vl, -1, torch.where(valid, j, zero).long())
            term = torch.where(valid, v * (1.0 - (j - t).abs()), zero)
            out = term if out is None else out + term
        cols.append(torch.where(torch.isnan(t), t, out))
        off += w
    return torch.cat(cols, dim=-1)


def _offsets(widths: Sequence[int]):
    ints = ctypes.c_int * len(widths)
    return (ints(*[sum(widths[:i]) for i in range(len(widths))]),
            ints(*widths))


def _check_cuda(name, tensors, x, widths, radius):
    """Validate the kernels' operands; returns the widths as ints."""
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on {[t.device for t in tensors]}"
                         f"; all must be on one CUDA device")
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous float32 tensors")
    widths = [int(w) for w in widths]
    if (not 1 <= len(widths) <= 8 or min(widths) < 0
            or not 0 <= radius <= 64):
        raise ValueError(f"{name} kernel takes 1..8 levels of width >= 0 "
                         f"and radius 0..64; got widths {widths}, radius "
                         f"{radius}")
    return widths


def vol_lookup(vcat: torch.Tensor, widths: Sequence[int], x: torch.Tensor,
               radius: int) -> torch.Tensor:
    """Volume lookup: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (counted in ``vol_lookup.launches``)."""
    if vcat.device.type == "cpu" and x.device.type == "cpu":
        return vol_lookup_plain(vcat, widths, x, radius)
    widths = _check_cuda("vol_lookup", (vcat, x), x, widths, radius)
    b, h, w1 = x.shape
    if vcat.shape != (b, h, w1, sum(widths)):
        raise ValueError(f"vcat {tuple(vcat.shape)} != "
                         f"{(b, h, w1, sum(widths))}")
    out = torch.empty((b, h, w1, len(widths) * (2 * radius + 1)),
                      dtype=torch.float32, device=x.device)
    fn = _build.load("corr_vol").corr_vol_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_long]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
    offs, wds = _offsets(widths)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(vcat.data_ptr(), x.data_ptr(), out.data_ptr(), b * h * w1,
                vcat.shape[3], radius, len(widths), offs, wds, stream)
    if rc != 0:
        raise RuntimeError(f"vol_lookup kernel launch failed: CUDA error "
                           f"{rc}")
    vol_lookup.launches += 1
    return out


vol_lookup.launches = 0


def vol_lookup_backward_plain(x: torch.Tensor, g: torch.Tensor,
                              widths: Sequence[int],
                              radius: int) -> torch.Tensor:
    """Plain PyTorch VJP in the TPU kernel's dense form: per level, the
    hat rows max(0, 1 - |j - t_k|) over the level's real columns, summed
    with their cotangents in ascending k.  x (B, H, W1), g (B, H, W1,
    L*(2r+1)) -> dvcat (B, H, W1, sum(widths))."""
    k = 2 * radius + 1
    g = g.float()
    zero = torch.zeros((), device=x.device)
    parts = []
    for lvl, w in enumerate(widths):
        t = level_taps(x, lvl, radius)
        j = torch.arange(w, dtype=torch.float32, device=x.device)
        acc = torch.zeros(x.shape + (w,), device=x.device)
        for i in range(k):
            hat = torch.maximum(1.0 - (j - t[..., i, None]).abs(), zero)
            acc = acc + g[..., lvl * k + i, None] * hat  # NaN stays
        parts.append(acc)
    return torch.cat(parts, dim=-1)


def vol_lookup_backward(x: torch.Tensor, g: torch.Tensor,
                        widths: Sequence[int], radius: int) -> torch.Tensor:
    """VJP of ``vol_lookup`` with respect to the volume, for the cotangent
    ``g``: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (counted in ``vol_lookup_backward.launches``).  Two calls on
    the same CUDA inputs are bitwise equal."""
    if x.device.type == "cpu" and g.device.type == "cpu":
        return vol_lookup_backward_plain(x, g, widths, radius)
    widths = _check_cuda("vol_lookup_backward", (x, g), x, widths, radius)
    b, h, w1 = x.shape
    if g.shape != (b, h, w1, len(widths) * (2 * radius + 1)):
        raise ValueError(f"g {tuple(g.shape)} != "
                         f"{(b, h, w1, len(widths) * (2 * radius + 1))}")
    dvol = torch.empty((b, h, w1, sum(widths)), dtype=torch.float32,
                       device=x.device)
    fn = _build.load("corr_vol_bwd").corr_vol_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_long]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
    offs, wds = _offsets(widths)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), g.data_ptr(), dvol.data_ptr(), b * h * w1,
                sum(widths), radius, len(widths), offs, wds, stream)
    if rc != 0:
        raise RuntimeError(f"vol_lookup_backward kernel launch failed: CUDA "
                           f"error {rc}")
    vol_lookup_backward.launches += 1
    return dvol


vol_lookup_backward.launches = 0


class _VolLookupFunction(torch.autograd.Function):
    """``vol_lookup`` with ``vol_lookup_backward`` as its VJP.  Saves only
    x; x gets no gradient (the model detaches the disparity before every
    lookup, and the JAX VJP returns zeros for the taps)."""

    @staticmethod
    def forward(ctx, vcat, x, widths, radius):
        ctx.save_for_backward(x)
        ctx.widths, ctx.radius = tuple(widths), radius
        return vol_lookup(vcat, widths, x, radius)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        dvol = vol_lookup_backward(x, g.contiguous(), ctx.widths, ctx.radius)
        return dvol, None, None, None


def vol_lookup_autograd(vcat: torch.Tensor, widths: Sequence[int],
                        x: torch.Tensor, radius: int) -> torch.Tensor:
    """Differentiable ``vol_lookup``: the gradient reaches the volume
    through ``vol_lookup_backward``."""
    return _VolLookupFunction.apply(vcat, x, tuple(widths), radius)
