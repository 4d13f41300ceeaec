"""On-demand correlation lookup: the CUDA kernels ``csrc/alt_corr.cu``
(forward), ``csrc/alt_corr_epi.cu`` (forward with the motion encoder's
convc1 fused in) and ``csrc/alt_corr_bwd.cu`` (its VJP), their plain
PyTorch versions, and the ``torch.autograd.Function`` that joins the
forward and the VJP.

Replaces the TPU kernel ``raftstereo_tpu/ops/pallas_alt.py``
``_alt_pyr_radial_kernel`` (core ``_radial_cols``).  The function, for
each pixel and level l with level-0 coordinate x: the 2r+1 align-corners
taps around x * 2^-l of <fmap1[x1], fmap2_l[j]> / sqrt(C), zero where j is
outside [0, w2_l - 1]; NaN coordinates give NaN.

The bound on an H100 and what the kernel's design does about it are in
the source's note: bytes bound (about 100 MB per call at the flagship
shapes, about 30 us at 3.35 TB/s); a block stages a tile of 32 pixels'
fmap1 rows and the span of fmap2 rows their windows cover in shared
memory, and each thread sums whole window dot products from there (a
level whose span outgrows the staging buffer reads fmap2 from global
memory instead, in the same kernel).

The backward replaces ``_alt_pyr_bwd_kernel`` of the same file, with the
radial taps of ``_make_alt_pyr_radial``'s VJP: bytes bound (about 521 MB
per call at the training shapes, about 0.16 ms); one block of 32 warps
per image row and 128-channel slice, which re-reads its slice of the
row's fmaps through L1; deterministic, with no floating-point atomics;
NaN and +-inf where the dense hat gives them (see the source's note).

The forward takes fp32 or bf16 feature maps and emits fp32 or bf16
features (``out_dtype``), accumulating in fp32 and rounding once; the
bf16 serving path's form reads about 53 MB per call (about 16 us).

``alt_corr_epi`` replaces ``_alt_pyr_radial_epi_kernel`` of the same
file: the lookup's columns rounded to bf16, then ``relu(cols @ W + b)``
with bf16 W and b, fp32 sums, bf16 out.  Inference-only, as in the JAX
package (training keeps the module conv).  Bytes bound: about 55 MB per
call at the bf16 serving shapes, about 17 us.

``alt_corr``, ``alt_corr_epi`` and ``alt_corr_backward`` run the plain
version for CPU tensors and the kernel for CUDA tensors; they never fall
back from one to the other.  ``alt_corr_autograd`` is the differentiable
lookup.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build


def alt_corr_plain(fmap1: torch.Tensor, f2cat: torch.Tensor,
                   widths: Sequence[int], x: torch.Tensor, radius: int,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: each level's correlation rows as one fp32
    matmul, then the K+1 integer windows around floor(x_l) and the lerp
    by frac(x_l) — the TPU kernel's arithmetic.  fmap1 (B, H, W1, C),
    f2cat (B, H, sum(widths), C), x (B, H, W1) -> (B, H, W1, L*(2r+1)) in
    ``out_dtype``.  bf16 feature maps are widened to fp32 first (never a
    bf16 matmul, which would round each correlation row before the lerp);
    a bf16 output is the fp32 result rounded once."""
    fmap1, f2cat = fmap1.float(), f2cat.float()
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
    return torch.stack(cols, dim=-1).to(out_dtype)


_DTYPES = (torch.float32, torch.bfloat16)


def _check_cuda(name, fmap1, f2cat, widths, x, radius, extra=(),
                fmap_dtypes=(torch.float32,)):
    """Validate the kernels' operands; returns (b, h, w1, c, widths)."""
    tensors = (fmap1, f2cat, x) + tuple(extra)
    dev = fmap1.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on {[t.device for t in tensors]}"
                         f"; all must be on one CUDA device")
    b, h, w1, c = fmap1.shape
    widths = [int(w) for w in widths]
    if f2cat.shape != (b, h, sum(widths), c):
        raise ValueError(f"f2cat {tuple(f2cat.shape)} != "
                         f"{(b, h, sum(widths), c)}")
    if x.shape != (b, h, w1):
        raise ValueError(f"x {tuple(x.shape)} != {(b, h, w1)}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    if (fmap1.dtype not in fmap_dtypes or f2cat.dtype != fmap1.dtype
            or x.dtype != torch.float32):
        raise ValueError(f"{name} takes fmap1 and f2cat of one dtype in "
                         f"{fmap_dtypes} and float32 x; got {fmap1.dtype}, "
                         f"{f2cat.dtype}, {x.dtype}")
    chunk = 256 if fmap1.dtype == torch.bfloat16 else 128
    if (c % chunk or c > 512 or not 1 <= radius <= 8
            or not 1 <= len(widths) <= 8):
        raise ValueError(f"{name} kernel takes C in {{{chunk}..512}} step "
                         f"{chunk}, radius 1..8 and 1..8 levels; got C={c}, "
                         f"radius={radius}, levels={len(widths)}")
    if fmap1.data_ptr() % 16 or f2cat.data_ptr() % 16:
        raise ValueError(f"{name} needs 16-byte aligned feature maps")
    return b, h, w1, c, widths


def alt_corr(fmap1: torch.Tensor, f2cat: torch.Tensor,
             widths: Sequence[int], x: torch.Tensor, radius: int,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """On-demand lookup: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (counted in ``alt_corr.launches``).  fmap1
    and f2cat fp32 or bf16; the output in ``out_dtype`` (fp32 or bf16)."""
    if all(t.device.type == "cpu" for t in (fmap1, f2cat, x)):
        return alt_corr_plain(fmap1, f2cat, widths, x, radius, out_dtype)
    b, h, w1, c, widths = _check_cuda("alt_corr", fmap1, f2cat, widths, x,
                                      radius, fmap_dtypes=_DTYPES)
    if out_dtype not in _DTYPES:
        raise ValueError(f"alt_corr emits float32 or bfloat16, not "
                         f"{out_dtype}")
    dev = fmap1.device
    nlev = len(widths)
    out = torch.empty((b, h, w1, nlev * (2 * radius + 1)), dtype=out_dtype,
                      device=dev)
    offs = [sum(widths[:i]) for i in range(nlev)]
    lib = _build.load("alt_corr")
    fn = lib.alt_corr_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_long]
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p])
    ints = ctypes.c_int * nlev
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(fmap1.data_ptr(), f2cat.data_ptr(), x.data_ptr(),
                out.data_ptr(), b * h * w1, w1, f2cat.shape[2], c, radius,
                1.0 / float(c) ** 0.5, nlev, ints(*offs), ints(*widths),
                int(fmap1.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"alt_corr kernel launch failed: CUDA error {rc}")
    alt_corr.launches += 1
    return out


alt_corr.launches = 0


def alt_corr_epi_plain(fmap1: torch.Tensor, f2cat: torch.Tensor,
                       widths: Sequence[int], x: torch.Tensor, radius: int,
                       w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the lookup with convc1 fused: the fp32
    columns of ``alt_corr_plain`` rounded to bf16, an fp32 product with
    the bf16 weights (exact products, fp32 sums: the kernel's and the
    TPU's arithmetic), rounded to bf16, plus the bias in bf16, relu.
    w (L*(2r+1), Co), b (Co) -> (B, H, W1, Co) bf16."""
    cols = alt_corr_plain(fmap1, f2cat, widths, x, radius, torch.bfloat16)
    y = torch.matmul(cols.float(), w.to(torch.bfloat16).float())
    return torch.relu(y.to(torch.bfloat16) + b.to(torch.bfloat16))


def alt_corr_epi(fmap1: torch.Tensor, f2cat: torch.Tensor,
                 widths: Sequence[int], x: torch.Tensor, radius: int,
                 w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """On-demand lookup with the motion encoder's convc1 + relu fused in
    (w (L*(2r+1), 64), b (64), bf16 on the card): the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors (counted in
    ``alt_corr_epi.launches``).  Returns (B, H, W1, 64) bf16."""
    if all(t.device.type == "cpu" for t in (fmap1, f2cat, x, w, b)):
        return alt_corr_epi_plain(fmap1, f2cat, widths, x, radius, w, b)
    bb, h, w1, c, widths = _check_cuda("alt_corr_epi", fmap1, f2cat, widths,
                                       x, radius, extra=(w, b),
                                       fmap_dtypes=_DTYPES)
    nlev = len(widths)
    lk = nlev * (2 * radius + 1)
    if (w.shape != (lk, 64) or b.shape != (64,)
            or w.dtype != torch.bfloat16 or b.dtype != torch.bfloat16):
        raise ValueError(f"alt_corr_epi takes bf16 w {(lk, 64)} and b (64,);"
                         f" got {w.dtype} {tuple(w.shape)}, {b.dtype} "
                         f"{tuple(b.shape)}")
    dev = fmap1.device
    out = torch.empty((bb, h, w1, 64), dtype=torch.bfloat16, device=dev)
    offs = [sum(widths[:i]) for i in range(nlev)]
    lib = _build.load("alt_corr_epi")
    fn = lib.alt_corr_epi_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_long]
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_void_p])
    ints = ctypes.c_int * nlev
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(fmap1.data_ptr(), f2cat.data_ptr(), x.data_ptr(),
                w.data_ptr(), b.data_ptr(), out.data_ptr(), bb * h * w1, w1,
                f2cat.shape[2], c, radius, 1.0 / float(c) ** 0.5, nlev,
                ints(*offs), ints(*widths),
                int(fmap1.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"alt_corr_epi kernel launch failed: CUDA error "
                           f"{rc}")
    alt_corr_epi.launches += 1
    return out


alt_corr_epi.launches = 0


def alt_corr_backward_plain(fmap1: torch.Tensor, f2cat: torch.Tensor,
                            widths: Sequence[int], x: torch.Tensor,
                            g: torch.Tensor, radius: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch VJP of the lookup, in the TPU kernel's form: per level
    the dense hat matrix dm[i, j] = s * sum_k g[i, k] * max(0, 1 - |j -
    t_k|) over the level's real columns (t_k = x * 2^-l + k - r), then two
    matmuls.  A NaN coordinate or cotangent makes that level's hat row
    NaN; an infinite cotangent makes it +-inf on the (at most two) columns
    its tap weights and NaN (inf * 0) on the others, as on the TPU.
    g (B, H, W1, L*(2r+1)) ->
    ``(df1, df2cat)`` shaped like fmap1 and f2cat."""
    c = fmap1.shape[-1]
    scale = 1.0 / float(c) ** 0.5
    k = 2 * radius + 1
    x = x.float()
    g = g.float()
    df1 = torch.zeros_like(fmap1, dtype=torch.float32)
    parts = []
    off = 0
    for lvl, w2 in enumerate(widths):
        if w2 == 0:
            continue
        xl = x * (1.0 / 2.0 ** lvl)
        j = torch.arange(w2, dtype=torch.float32, device=x.device)
        dm = None
        for t in range(k):
            tap = (xl + float(t - radius))[..., None]
            w = torch.maximum(1.0 - (j - tap).abs(),
                              torch.zeros((), device=x.device))  # NaN stays
            term = g[..., lvl * k + t, None] * w
            dm = term if dm is None else dm + term
        dm = dm * scale                                    # (B, H, W1, w2)
        f2 = f2cat[:, :, off:off + w2]
        df1 = df1 + torch.matmul(dm, f2)
        parts.append(torch.matmul(dm.transpose(-1, -2), fmap1))
        off += w2
    return df1, torch.cat(parts, dim=2)


def alt_corr_backward(fmap1: torch.Tensor, f2cat: torch.Tensor,
                      widths: Sequence[int], x: torch.Tensor,
                      g: torch.Tensor, radius: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """VJP of ``alt_corr`` for the cotangent ``g``: the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors (counted in
    ``alt_corr_backward.launches``).  Returns ``(df1, df2cat)``; two calls
    on the same CUDA inputs are bitwise equal."""
    if all(t.device.type == "cpu" for t in (fmap1, f2cat, x, g)):
        return alt_corr_backward_plain(fmap1, f2cat, widths, x, g, radius)
    b, h, w1, c, widths = _check_cuda("alt_corr_backward", fmap1, f2cat,
                                      widths, x, radius, extra=(g,))
    if g.dtype != torch.float32:
        raise ValueError(f"alt_corr_backward takes a float32 cotangent, not "
                         f"{g.dtype}")
    nlev = len(widths)
    if g.shape != (b, h, w1, nlev * (2 * radius + 1)):
        raise ValueError(f"g {tuple(g.shape)} != "
                         f"{(b, h, w1, nlev * (2 * radius + 1))}")
    # The kernel keeps one image row's tables in shared memory.
    if w1 * nlev * (2 * radius + 3) * 4 > 232448 - 64:
        raise ValueError(f"alt_corr_backward: W1={w1} is too wide for the "
                         f"kernel's per-row tables")
    df1 = torch.empty_like(fmap1)
    df2 = torch.empty_like(f2cat)
    offs = [sum(widths[:i]) for i in range(nlev)]
    lib = _build.load("alt_corr_bwd")
    fn = lib.alt_corr_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_long]
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_void_p])
    ints = ctypes.c_int * nlev
    dev = fmap1.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(fmap1.data_ptr(), f2cat.data_ptr(), x.data_ptr(),
                g.data_ptr(), df1.data_ptr(), df2.data_ptr(), b * h, w1,
                f2cat.shape[2], c, radius, 1.0 / float(c) ** 0.5, nlev,
                ints(*offs), ints(*widths), stream)
    if rc != 0:
        raise RuntimeError(f"alt_corr_backward kernel launch failed: CUDA "
                           f"error {rc}")
    alt_corr_backward.launches += 1
    return df1, df2


alt_corr_backward.launches = 0


class _AltCorrFunction(torch.autograd.Function):
    """``alt_corr`` with ``alt_corr_backward`` as its VJP.  Saves fmap1,
    f2cat and x; x gets no gradient (the model detaches the disparity
    before every lookup, and the JAX VJP returns zeros for it)."""

    @staticmethod
    def forward(ctx, fmap1, f2cat, x, widths, radius):
        ctx.save_for_backward(fmap1, f2cat, x)
        ctx.widths, ctx.radius = tuple(widths), radius
        return alt_corr(fmap1, f2cat, widths, x, radius)

    @staticmethod
    def backward(ctx, g):
        fmap1, f2cat, x = ctx.saved_tensors
        df1, df2 = alt_corr_backward(fmap1, f2cat, ctx.widths, x,
                                     g.contiguous(), ctx.radius)
        return df1, df2, None, None, None


def alt_corr_autograd(fmap1: torch.Tensor, f2cat: torch.Tensor,
                      widths: Sequence[int], x: torch.Tensor,
                      radius: int) -> torch.Tensor:
    """Differentiable ``alt_corr``: gradients reach fmap1 and f2cat
    through ``alt_corr_backward``."""
    return _AltCorrFunction.apply(fmap1, f2cat, x, tuple(widths), radius)
