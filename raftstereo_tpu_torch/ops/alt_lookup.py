"""The on-demand correlation lookup at caller-given taps, all pyramid
levels in one call: twins of the JAX package's op functions
``pallas_alt_lookup``, ``pallas_alt_lookup_flat`` and
``pallas_alt_pyramid_flat`` (``raftstereo_tpu/ops/pallas_alt.py``), the
CUDA kernels ``csrc/alt_corr_taps.cu`` (forward) and
``csrc/alt_corr_taps_bwd.cu`` (its VJP), their plain PyTorch versions,
and the ``torch.autograd.Function`` that joins them.

The forward replaces the TPU kernel ``_alt_pyr_fwd_kernel`` and the
backward ``_alt_pyr_bwd_kernel`` as ``_make_alt_pyr``'s VJP launches it,
with arbitrary taps (``cuda_alt.alt_corr_backward`` is that kernel's
radial form).  The function, for pixel (b, y, x1) and tap q of level l
with local coordinate t and level width w_l:

    out[b, y, x1, q] = sum_{j in [0, w_l)} M_l[j] * max(0, 1 - |j - t|),
    M_l[j] = <fmap1[b, y, x1], fmap2_l[b, y, j]> / sqrt(C),

so taps outside (-1, w_l) give 0 and NaN taps give NaN.  The gradient
reaches both feature maps, in their dtype; the taps get a zero gradient,
as the JAX VJP returns.  With bf16 feature maps each pixel's scaled
coefficient on a column (its taps' terms summed in tap order) is rounded
to bf16 once before the products, as the TPU kernel rounds ``dm``; the
cotangent is widened to fp32.  The bounds on an H100 and what each
design does about them are in the sources' notes (both bound by bytes).

The TPU padding is gone: ``preflatten_fmap1``/``preflatten_fmap2`` are
reshapes, and a level takes its real width.  Zero columns that a caller
pads on correlate to zero, so a padded call still gives JAX's result.

``alt_corr_taps`` and ``alt_corr_taps_backward`` run the plain version
for CPU tensors and the kernel for CUDA tensors (counted in their
``launches``); they never fall back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_LEVELS = 8  # the kernels' per-launch level table


def _levels(widths: Sequence[int], lk: int) -> Tuple[list, int]:
    widths = [int(w) for w in widths]
    if not widths or lk % len(widths):
        raise ValueError(f"{lk} taps do not split over {len(widths)} levels")
    return widths, lk // len(widths)


def alt_corr_taps_plain(f1flat: torch.Tensor, f2cat: torch.Tensor,
                        taps: torch.Tensor, widths: Sequence[int],
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Plain PyTorch version: each level's correlation rows as one fp32
    matmul, then per tap the two columns floor(t) and floor(t) + 1 inside
    the level, weighted 1 - f and f (the kernel's arithmetic; the TPU
    sweeps the dense hat, equal up to fp32 rounding).  f1flat (N, W1, C),
    f2cat (N, sum(widths), C), taps (N, W1, L*K) -> (N, W1, L*K) in
    ``out_dtype``; bf16 feature maps are widened to fp32 first."""
    widths, kk = _levels(widths, taps.shape[-1])
    f1, f2 = f1flat.float(), f2cat.float()
    scale = 1.0 / float(f1.shape[-1]) ** 0.5
    taps = taps.float()
    cols, off = [], 0
    for lvl, w in enumerate(widths):
        t = taps[..., lvl * kk:(lvl + 1) * kk]
        ok = (t > -1.0) & (t < float(w))  # False for NaN and +-inf
        if w == 0:
            cols.append(torch.zeros_like(t))
            continue
        m = torch.matmul(f1, f2[:, off:off + w].transpose(-1, -2)) * scale
        b0 = torch.floor(torch.where(ok, t, torch.zeros_like(t)))
        f = t - b0
        vals = []
        for j in (b0, b0 + 1.0):
            inside = ok & (j >= 0) & (j <= w - 1)
            idx = torch.where(inside, j, torch.zeros_like(j)).long()
            v = torch.gather(m, 2, idx)
            vals.append(torch.where(inside, v, torch.zeros_like(v)))
        out = vals[0] * (1.0 - f) + vals[1] * f
        out = torch.where(ok, out, torch.zeros_like(out))
        cols.append(torch.where(t.isnan(), torch.full_like(out, float("nan")),
                                out))
        off += w
    return torch.cat(cols, dim=-1).to(out_dtype)


def _check_cuda(name, f1flat, f2cat, taps, widths, extra=(),
                fmap_dtypes=_DTYPES):
    tensors = (f1flat, f2cat, taps) + tuple(extra)
    dev = f1flat.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on {[t.device for t in tensors]}"
                         f"; all must be on one CUDA device")
    n, w1, c = f1flat.shape
    widths, kk = _levels(widths, taps.shape[-1])
    if f2cat.shape != (n, sum(widths), c):
        raise ValueError(f"f2cat {tuple(f2cat.shape)} != "
                         f"{(n, sum(widths), c)}")
    if taps.shape != (n, w1, len(widths) * kk):
        raise ValueError(f"taps {tuple(taps.shape)} != "
                         f"{(n, w1, len(widths) * kk)}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    if (f1flat.dtype not in fmap_dtypes or f2cat.dtype != f1flat.dtype
            or taps.dtype != torch.float32):
        raise ValueError(f"{name} takes f1flat and f2cat of one dtype in "
                         f"{fmap_dtypes} and float32 taps; got "
                         f"{f1flat.dtype}, {f2cat.dtype}, {taps.dtype}")
    if c < 1 or not 1 <= len(widths) <= _MAX_LEVELS:
        raise NotImplementedError(
            f"{name}: C={c} with {len(widths)} levels; the kernel takes "
            f"C >= 1 and 1..{_MAX_LEVELS} levels (see ROADMAP.md Queue 2, "
            f"limits of the op-path kernels)")
    return n, w1, c, widths, kk


def _kernel_layout(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """``t`` (N, W, C) as the kernels read it: C zero-padded to a
    multiple of ``chunk`` (zero channels add exact zeros to every dot) and
    16-byte aligned."""
    pad = -t.shape[-1] % chunk
    if pad:
        return torch.nn.functional.pad(t, (0, pad))
    return t.clone() if t.data_ptr() % 16 else t


def alt_corr_taps(f1flat: torch.Tensor, f2cat: torch.Tensor,
                  taps: torch.Tensor, widths: Sequence[int],
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The lookup at given taps: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (counted in ``alt_corr_taps.launches``).
    f1flat (N, W1, C) and f2cat (N, sum(widths), C) fp32 or bf16, taps
    (N, W1, L*K) fp32 -> (N, W1, L*K) in ``out_dtype`` (fp32 or bf16)."""
    if all(t.device.type == "cpu" for t in (f1flat, f2cat, taps)):
        return alt_corr_taps_plain(f1flat, f2cat, taps, widths, out_dtype)
    out = _taps_kernel(f1flat, f2cat, taps, widths, out_dtype)
    alt_corr_taps.launches += 1
    return out


_FORMS = {"auto": -1, "tiled": 0, "general": 1}


def alt_corr_taps_form(w1: int, widths: Sequence[int], kk: int) -> str:
    """The kernel's form at these sizes: ``"tiled"`` (a block per image
    row, tile of pixels and group of levels) or ``"general"`` (a warp per
    pixel, where a tile's dots outgrow shared memory).  Builds the kernel
    on first use (needs the CUDA toolkit)."""
    widths = [int(w) for w in widths]
    fn = _build.load("alt_corr_taps").alt_corr_taps_forward_form
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    rc = fn(w1, kk, len(widths), (ctypes.c_int * len(widths))(*widths))
    if rc not in (0, 1):
        raise ValueError(f"alt_corr_taps takes 1..{_MAX_LEVELS} levels, "
                         f"not {len(widths)}")
    return ("tiled", "general")[rc]


def _taps_kernel(f1flat, f2cat, taps, widths, out_dtype, form="auto"):
    """``alt_corr_taps``' CUDA kernel, uncounted, in the given form
    (``"auto"``: the one ``alt_corr_taps_form`` names; ``"tiled"`` or
    ``"general"`` to time one against the other)."""
    n, w1, c, widths, kk = _check_cuda("alt_corr_taps", f1flat, f2cat, taps,
                                       widths)
    if out_dtype not in _DTYPES:
        raise ValueError(f"alt_corr_taps emits float32 or bfloat16, not "
                         f"{out_dtype}")
    nlev = len(widths)
    chunk = 256 if f1flat.dtype == torch.bfloat16 else 128
    f1flat, f2cat = (_kernel_layout(t, chunk) for t in (f1flat, f2cat))
    out = torch.empty(taps.shape, dtype=out_dtype, device=taps.device)
    offs = [sum(widths[:i]) for i in range(nlev)]
    fn = _build.load("alt_corr_taps").alt_corr_taps_forward_as
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_long]
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p])
    ints = ctypes.c_int * nlev
    dev = f1flat.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(_FORMS[form], f1flat.data_ptr(), f2cat.data_ptr(),
                taps.data_ptr(), out.data_ptr(), n * w1, w1, f2cat.shape[1],
                f1flat.shape[-1], kk, 1.0 / float(c) ** 0.5, nlev,
                ints(*offs), ints(*widths),
                int(f1flat.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"alt_corr_taps kernel launch failed: CUDA error "
                           f"{rc}")
    return out


alt_corr_taps.launches = 0


def alt_corr_taps_backward_plain(f1flat: torch.Tensor, f2cat: torch.Tensor,
                                 taps: torch.Tensor, g: torch.Tensor,
                                 widths: Sequence[int]
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch VJP in the TPU kernel's form: per level the dense hat
    matrix dm[i, j] = s * sum_k g[i, k] * max(0, 1 - |j - t_k|) over the
    level's columns, then two matmuls.  A NaN tap or a non-finite
    cotangent makes that level's hat row NaN, as on the TPU.  With bf16
    feature maps dm is rounded to bf16 before the products (fp32 sums of
    exact products) and the gradients once at the end.  Returns
    ``(df1, df2cat)`` shaped like f1flat and f2cat, in their dtype."""
    widths, kk = _levels(widths, taps.shape[-1])
    bf16 = f1flat.dtype == torch.bfloat16
    f1, f2 = f1flat.float(), f2cat.float()
    scale = 1.0 / float(f1.shape[-1]) ** 0.5
    taps, g = taps.float(), g.float()
    zero = torch.zeros((), device=taps.device)
    df1 = torch.zeros_like(f1)
    parts, off = [], 0
    for lvl, w in enumerate(widths):
        if w == 0:
            continue
        j = torch.arange(w, dtype=torch.float32, device=taps.device)
        dm = None
        for k in range(lvl * kk, (lvl + 1) * kk):
            hat = torch.maximum(1.0 - (j - taps[..., k, None]).abs(), zero)
            term = g[..., k, None] * hat  # NaN stays NaN
            dm = term if dm is None else dm + term
        dm = dm * scale                                    # (N, W1, w)
        if bf16:
            dm = dm.to(torch.bfloat16).float()
        df1 = df1 + torch.matmul(dm, f2[:, off:off + w])
        parts.append(torch.matmul(dm.transpose(-1, -2), f1))
        off += w
    df2 = torch.cat(parts, dim=1) if parts else torch.zeros_like(f2)
    return df1.to(f1flat.dtype), df2.to(f2cat.dtype)


def alt_corr_taps_backward(f1flat: torch.Tensor, f2cat: torch.Tensor,
                           taps: torch.Tensor, g: torch.Tensor,
                           widths: Sequence[int]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """VJP of ``alt_corr_taps`` for the cotangent ``g`` (fp32 or bf16,
    widened to fp32): the plain version for CPU tensors, the CUDA kernels
    for CUDA tensors (one count in ``alt_corr_taps_backward.launches`` a
    call, which launches two kernels, ``alt_corr_taps_bwd_lists_kernel``
    then ``alt_corr_taps_bwd_grads_kernel``, per batch of rows), their
    bf16 form for bf16 feature maps.  Returns ``(df1, df2cat)`` in the
    maps' dtype; two calls on the same CUDA inputs give equal bits.
    The lists take a workspace of up to 32 bytes a tap: a batch of rows
    takes at most 256 MiB, or one row's lists where a row needs more
    (``alt_corr_taps_backward_batch``)."""
    if all(t.device.type == "cpu" for t in (f1flat, f2cat, taps, g)):
        return alt_corr_taps_backward_plain(f1flat, f2cat, taps, g, widths)
    n, w1, c, widths, kk = _check_cuda(
        "alt_corr_taps_backward", f1flat, f2cat, taps, widths, extra=(g,))
    if g.dtype not in _DTYPES or g.shape != taps.shape:
        raise ValueError(f"alt_corr_taps_backward takes a float32 or "
                         f"bfloat16 cotangent shaped like the taps; got "
                         f"{g.dtype} {tuple(g.shape)}")
    g = g.float().contiguous()  # exact: the kernels read fp32
    nlev, w2cat = len(widths), f2cat.shape[1]
    lib = _build.load("alt_corr_taps_bwd")
    tile = lib.alt_corr_taps_backward_tile
    tile.restype = ctypes.c_int
    tile.argtypes = [ctypes.c_int] * 4
    if tile(w1, w2cat, nlev, kk) < 1:
        raise NotImplementedError(
            f"alt_corr_taps_backward: {nlev * kk} taps per pixel; one "
            f"pixel's tables must fit in shared memory (see ROADMAP.md "
            f"Queue 2, limits of the op-path kernels; the lists' workspace "
            f"takes up to 32 bytes a tap, at most 256 MiB a batch of rows "
            f"or one row's)")
    space = lib.alt_corr_taps_backward_workspace
    space.restype = ctypes.c_long
    space.argtypes = [ctypes.c_long] + [ctypes.c_int] * 4
    bf16 = f1flat.dtype == torch.bfloat16
    f1flat, f2cat = (_kernel_layout(t, 256 if bf16 else 128)
                     for t in (f1flat, f2cat))
    df1 = torch.empty_like(f1flat)
    df2 = torch.empty_like(f2cat)
    # the kernels' lists of runs and entries (the caching allocator's
    # blocks are 512-byte aligned)
    work = torch.empty(space(n, w1, w2cat, nlev, kk), dtype=torch.uint8,
                       device=f1flat.device)
    offs = [sum(widths[:i]) for i in range(nlev)]
    fn = (lib.alt_corr_taps_backward_bf16 if bf16
          else lib.alt_corr_taps_backward)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_long]
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_void_p])
    ints = ctypes.c_int * nlev
    dev = f1flat.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(f1flat.data_ptr(), f2cat.data_ptr(), taps.data_ptr(),
                g.data_ptr(), df1.data_ptr(), df2.data_ptr(),
                work.data_ptr(), n, w1, w2cat, f1flat.shape[-1], kk,
                1.0 / float(c) ** 0.5, nlev, ints(*offs), ints(*widths),
                stream)
    if rc != 0:
        raise RuntimeError(f"alt_corr_taps_backward kernel launch failed: "
                           f"CUDA error {rc}")
    alt_corr_taps_backward.launches += 1
    if df1.shape[-1] != c:
        df1, df2 = df1[..., :c].contiguous(), df2[..., :c].contiguous()
    return df1, df2


alt_corr_taps_backward.launches = 0


class _AltTapsFunction(torch.autograd.Function):
    """``alt_corr_taps`` with ``alt_corr_taps_backward`` as its VJP, the
    gradients in the maps' dtype; the taps get a zero gradient, as
    ``_make_alt_pyr.bwd`` returns."""

    @staticmethod
    def forward(ctx, f1flat, f2cat, taps, widths, out_dtype):
        ctx.save_for_backward(f1flat, f2cat, taps)
        ctx.widths = widths
        return alt_corr_taps(f1flat, f2cat, taps, widths, out_dtype)

    @staticmethod
    def backward(ctx, g):
        f1flat, f2cat, taps = ctx.saved_tensors
        df1, df2 = alt_corr_taps_backward(f1flat, f2cat, taps,
                                          g.contiguous(), ctx.widths)
        return df1, df2, torch.zeros_like(taps), None, None


def preflatten_fmap1(fmap1: torch.Tensor) -> torch.Tensor:
    """(B, H, W1, C) -> (B*H, W1, C): a reshape (no TPU padding)."""
    return fmap1.reshape(-1, *fmap1.shape[2:])


def preflatten_fmap2(fmap2: torch.Tensor) -> torch.Tensor:
    """(B, H, W2, C) -> (B*H, W2, C): a reshape (no TPU padding)."""
    return fmap2.reshape(-1, *fmap2.shape[2:])


def pallas_alt_pyramid_flat(f1flat: torch.Tensor, f2cat: torch.Tensor,
                            taps: torch.Tensor, w2s: Sequence[int],
                            precision: str = "highest",
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """All pyramid levels in one call (differentiable in both feature
    maps).  f1flat (B*H, W1, C); f2cat (B*H, sum(w2s), C), the levels
    concatenated along W; taps (B, H, W1, L*K), level-major, per-level
    local coordinates; w2s the level widths.  Returns (B, H, W1, L*K) in
    ``out_dtype``, scaled by 1/sqrt(C), zero outside each level and NaN
    at NaN taps."""
    if precision != "highest":
        raise NotImplementedError(
            f"precision={precision!r} (reduced-precision correlation "
            f"products) is not ported yet; see ROADMAP.md Queue 1 item 2 "
            f"(corr_precision)")
    b, h, w1, lk = taps.shape
    if f1flat.shape[:2] != (b * h, w1):
        raise ValueError(f"f1flat {tuple(f1flat.shape)} does not match taps "
                         f"{tuple(taps.shape)}")
    out = _AltTapsFunction.apply(
        f1flat.contiguous(), f2cat.contiguous(),
        taps.reshape(b * h, w1, lk).float().contiguous(),
        tuple(int(w) for w in w2s), out_dtype)
    return out.reshape(b, h, w1, lk)


def pallas_alt_lookup_flat(f1flat: torch.Tensor, f2flat: torch.Tensor,
                           taps: torch.Tensor,
                           precision: str = "highest") -> torch.Tensor:
    """One level at its full width: taps (B, H, W1, K) into f2flat's W2."""
    return pallas_alt_pyramid_flat(f1flat, f2flat, taps, (f2flat.shape[1],),
                                   precision)


def pallas_alt_lookup(fmap1: torch.Tensor, fmap2: torch.Tensor,
                      taps: torch.Tensor) -> torch.Tensor:
    """On-demand correlation at the given taps: fmap1 (B, H, W1, C),
    fmap2 (B, H, W2, C), taps (B, H, W1, K) x-coordinates into W2 ->
    (B, H, W1, K) fp32, align-corners linear interpolation, zero outside
    [0, W2 - 1]."""
    return pallas_alt_lookup_flat(preflatten_fmap1(fmap1),
                                  preflatten_fmap2(fmap2), taps)
