"""Stand-alone instance norm with an optional fused relu: the twin of the
JAX package's ``instance_norm_act`` (``raftstereo_tpu/ops/pallas_norm.py``),
the CUDA kernels of ``csrc/inorm.cu`` and their plain PyTorch versions.

Two launches, as on the TPU: ``in_stats`` replaces ``_in_stats_kernel``
(fp32 sums of x and x^2 over (H, W), ended here by the mean and the
rstd) and ``in_apply`` replaces ``_in_apply_kernel`` (normalise, relu).
The formula is the kernels', not ``models.layers.InstanceNorm``'s:

    mean = s1 / n,  var = max(s2 / n - mean^2, 0),
    rstd = 1 / sqrt(var + 1e-5),  y = (x - mean) * rstd

with ``mean`` and ``rstd`` cast to x's dtype before the apply (bf16
arithmetic rounds each step).  Tensors are NCHW, as in the port's
encoders; the JAX function takes NHWC.  The backward is autograd through
the plain centred formulation (``_xla_instance_norm``, which the JAX
VJP re-linearises), with ``jnp.maximum``'s tie convention for the relu:
there is no backward kernel, as the JAX package has none.  The bound on
an H100 and the kernels' design are in the source's note (bytes).

``in_stats`` and ``in_apply`` run the plain version for CPU tensors and
the kernel for CUDA tensors (counted in their ``launches``); they never
fall back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .encoder_bwd import drelu

_EPS = 1e-5
_DTYPES = (torch.float32, torch.bfloat16)


def in_stats_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, rstd), each (B, C) fp32, from fp32 sums over (H, W)."""
    xf = x.float()
    n = torch.full((), float(x.shape[2] * x.shape[3]), device=x.device)
    mean = xf.sum(dim=(2, 3)) / n  # a tensor divisor: a true division
    var = torch.maximum((xf * xf).sum(dim=(2, 3)) / n - mean * mean,
                        torch.zeros((), device=x.device))  # NaN stays
    return mean, torch.sqrt(var + _EPS).reciprocal()


def in_apply_plain(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                   relu: bool = False) -> torch.Tensor:
    """(x - mean) * rstd in x's dtype, then relu if asked."""
    m = mean.to(x.dtype)[:, :, None, None]
    s = rstd.to(x.dtype)[:, :, None, None]
    y = (x - m) * s
    return torch.relu(y) if relu else y


def _check(name: str, x: torch.Tensor, *extra: torch.Tensor) -> None:
    if x.device.type != "cuda" or any(t.device != x.device for t in extra):
        raise ValueError(f"{name}: operands on "
                         f"{[t.device for t in (x, *extra)]}; all must be "
                         f"on one CUDA device")
    if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous (B, C, H, W) float32 or "
                         f"bfloat16 tensor; got {x.dtype} {tuple(x.shape)}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def in_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(image, channel) mean and rstd of an NCHW tensor, each (B, C)
    fp32: the plain version for a CPU tensor, the stats kernel for a CUDA
    tensor (counted in ``in_stats.launches``)."""
    if x.device.type == "cpu":
        return in_stats_plain(x)
    _check("in_stats", x)
    b, c, h, w = x.shape
    stats = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    fn = _build.load("inorm").inorm_stats_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_long, ctypes.c_int,
                   ctypes.c_void_p]
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), stats.data_ptr(), b, c, h * w,
                int(x.dtype == torch.bfloat16), _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"in_stats kernel launch failed: CUDA error {rc}")
    in_stats.launches += 1
    return stats[:, 0], stats[:, 1]


in_stats.launches = 0


def in_apply(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
             relu: bool = False) -> torch.Tensor:
    """(x - mean) * rstd (+ relu) in x's dtype: the plain version for CPU
    tensors, the apply kernel for CUDA tensors (counted in
    ``in_apply.launches``).  ``mean`` and ``rstd`` are (B, C) fp32, as
    ``in_stats`` returns them."""
    if all(t.device.type == "cpu" for t in (x, mean, rstd)):
        return in_apply_plain(x, mean, rstd, relu)
    _check("in_apply", x, mean, rstd)
    b, c, h, w = x.shape
    stats = torch.stack([mean, rstd], dim=1).float().contiguous()
    if stats.shape != (b, 2, c):
        raise ValueError(f"in_apply: mean/rstd {tuple(mean.shape)} != "
                         f"{(b, c)}")
    y = torch.empty_like(x)
    fn = _build.load("inorm").inorm_apply_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_long, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), stats.data_ptr(), y.data_ptr(), b, c, h * w,
                int(relu), int(x.dtype == torch.bfloat16),
                _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"in_apply kernel launch failed: CUDA error {rc}")
    in_apply.launches += 1
    return y


in_apply.launches = 0


def _centred(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``_xla_instance_norm`` without the relu: fp32
    mean, centred variance, rsqrt, cast to x's dtype."""
    xf = x.float()
    c = xf - xf.mean(dim=(2, 3), keepdim=True)
    v = (c * c).mean(dim=(2, 3), keepdim=True)
    return (c * torch.rsqrt(v + _EPS)).to(x.dtype)


class _InstanceNormAct(torch.autograd.Function):
    """Forward: the two kernels.  Backward: autograd through ``_centred``,
    the relu's derivative 0.5 at a tie (``jnp.maximum``'s convention)."""

    @staticmethod
    def forward(ctx, x, relu):
        ctx.save_for_backward(x)
        ctx.relu = relu
        mean, rstd = in_stats(x)
        return in_apply(x, mean, rstd, relu)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            y = _centred(xr)
            if ctx.relu:
                g = g * drelu(y.detach())
            (dx,) = torch.autograd.grad(y, xr, g)
        return dx, None


def instance_norm_act(x: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """Instance norm (no affine, eps 1e-5) of an NCHW fp32 or bf16 tensor,
    optionally fused with relu; differentiable in ``x``."""
    return _InstanceNormAct.apply(x.contiguous(), relu)
