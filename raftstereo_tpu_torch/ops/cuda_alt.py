"""On-demand correlation lookup: the CUDA kernel ``csrc/alt_corr.cu`` and
its plain PyTorch version.

Replaces the TPU kernel ``raftstereo_tpu/ops/pallas_alt.py``
``_alt_pyr_radial_kernel`` (core ``_radial_cols``).  The function, for
each pixel and level l with level-0 coordinate x: the 2r+1 align-corners
taps around x * 2^-l of <fmap1[x1], fmap2_l[j]> / sqrt(C), zero where j is
outside [0, w2_l - 1]; NaN coordinates give NaN.

The bound on an H100 and what the kernel's design does about it are in
the source's note: bytes bound (about 100 MB per call at the flagship
shapes, about 30 us at 3.35 TB/s); one warp per pixel computes only the
window dot products the pixel needs.

``alt_corr`` runs the plain version for CPU tensors and the kernel for
CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build


def alt_corr_plain(fmap1: torch.Tensor, f2cat: torch.Tensor,
                   widths: Sequence[int], x: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """Plain PyTorch version: each level's correlation rows as one fp32
    matmul, then the K+1 integer windows around floor(x_l) and the lerp
    by frac(x_l) — the TPU kernel's arithmetic.  fmap1 (B, H, W1, C),
    f2cat (B, H, sum(widths), C), x (B, H, W1) -> (B, H, W1, L*(2r+1))."""
    c = fmap1.shape[-1]
    scale = 1.0 / float(c) ** 0.5
    k = 2 * radius + 1
    x = x.float()
    cols, off = [], 0
    for lvl, w2 in enumerate(widths):
        xl = x * (1.0 / 2.0 ** lvl)
        b0 = torch.floor(xl)
        fr = xl - b0
        m = None
        if w2 > 0:
            m = torch.matmul(fmap1, f2cat[:, :, off:off + w2]
                             .transpose(-1, -2)) * scale  # (B, H, W1, w2)
        wins = []
        for d in range(k + 1):
            jf = b0 + float(d - radius)
            valid = (jf >= 0) & (jf <= w2 - 1)  # False for NaN
            if m is None:
                wins.append(torch.zeros_like(xl))
                continue
            j = torch.where(valid, jf, torch.zeros_like(jf)).long()
            v = torch.gather(m, 3, j[..., None])[..., 0]
            wins.append(torch.where(valid, v, torch.zeros_like(v)))
        for t in range(k):
            cols.append(wins[t] * (1.0 - fr) + wins[t + 1] * fr)
        off += w2
    return torch.stack(cols, dim=-1)


def alt_corr(fmap1: torch.Tensor, f2cat: torch.Tensor,
             widths: Sequence[int], x: torch.Tensor,
             radius: int) -> torch.Tensor:
    """On-demand lookup: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (counted in ``alt_corr.launches``)."""
    tensors = (fmap1, f2cat, x)
    if all(t.device.type == "cpu" for t in tensors):
        return alt_corr_plain(fmap1, f2cat, widths, x, radius)
    dev = fmap1.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"alt_corr: tensors on {[t.device for t in tensors]}"
                         f"; all must be on one CUDA device")
    b, h, w1, c = fmap1.shape
    widths = [int(w) for w in widths]
    if f2cat.shape != (b, h, sum(widths), c):
        raise ValueError(f"f2cat {tuple(f2cat.shape)} != "
                         f"{(b, h, sum(widths), c)}")
    if x.shape != (b, h, w1):
        raise ValueError(f"x {tuple(x.shape)} != {(b, h, w1)}")
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("alt_corr takes contiguous float32 tensors")
    if c % 128 or c > 512 or not 1 <= radius <= 8 or not 1 <= len(widths) <= 8:
        raise ValueError(f"alt_corr kernel takes C in {{128..512}} step 128, "
                         f"radius 1..8 and 1..8 levels; got C={c}, "
                         f"radius={radius}, levels={len(widths)}")
    if fmap1.data_ptr() % 16 or f2cat.data_ptr() % 16:
        raise ValueError("alt_corr needs 16-byte aligned feature maps")
    nlev = len(widths)
    out = torch.empty((b, h, w1, nlev * (2 * radius + 1)),
                      dtype=torch.float32, device=dev)
    offs = [sum(widths[:i]) for i in range(nlev)]
    lib = _build.load("alt_corr")
    fn = lib.alt_corr_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_long]
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_void_p])
    ints = ctypes.c_int * nlev
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(fmap1.data_ptr(), f2cat.data_ptr(), x.data_ptr(),
                out.data_ptr(), b * h * w1, w1, f2cat.shape[2], c, radius,
                1.0 / float(c) ** 0.5, nlev, ints(*offs), ints(*widths),
                stream)
    if rc != 0:
        raise RuntimeError(f"alt_corr kernel launch failed: CUDA error {rc}")
    alt_corr.launches += 1
    return out


alt_corr.launches = 0
