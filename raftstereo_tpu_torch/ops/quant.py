"""Int8-quantized correlation volume (``corr_quant``): the CUDA kernel
``csrc/int8_volume.cu``, its plain PyTorch version, the row quantization
around it, and the serving accuracy-tier vocabulary.

The port's copy of the JAX package's ``ops/quant.py`` numeric core:
symmetric int8 quantization with one scale per correlation row (each
(b, h, w) feature vector), an int8 x int8 -> int32 all-pairs product, and
the dequant epilogue ``(acc * (s1 (x) s2)) * inv`` with inv = 1/sqrt(C)
computed once in fp32 on the host.  The integer sum is exact and the
epilogue is multiplies only in JAX's association, so the kernel, the
plain version and the JAX package's ``_int8_volume_xla`` give the same
bits.  The volume comes out in fp32 or, for the int8 tier, in bf16: the
fp32 epilogue's value rounded once (JAX: ``.astype(out_dtype)``).

The tier vocabulary is the JAX package's: a request's ``accuracy`` tier
names a precision mode, and ``config_for_mode`` swaps only the
numeric-policy fields of the base config onto it::

    certified -> fp32   (fp32 compute and correlation)
    fast      -> bf16   (bf16 compute, bf16 correlation)
    turbo     -> int8   (bf16 compute, the int8 volume in bf16)

Replaces the TPU kernel ``raftstereo_tpu/ops/quant.py``
``_int8_volume_kernel``.  Its bound on an H100 and what the design does
about it are in the source's note: bound by bytes (about 51 MB per call
at the serving shape, 15 us, most of it the fp32 volume it writes; 35
MB, 10 us, with a bf16 volume); the
product runs on the int8 tensor cores (``mma.sync`` m16n8k32 from
``ldmatrix``) and the epilogue stages each tile in shared memory for
coalesced 16-byte row stores.

``int8_corr_volume`` runs the plain version for CPU tensors and the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import _build

# Request-facing tier names, in decreasing accuracy.
TIERS = ("certified", "fast", "turbo")
# tier -> the precision mode of its model
TIER_MODES = {"certified": "fp32", "fast": "bf16", "turbo": "int8"}
MODES = ("fp32", "bf16", "int8")


def mode_for_accuracy(accuracy: str) -> str:
    """The precision mode of a request's ``accuracy`` tier; ``ValueError``
    on an unknown tier (a 400 at the server)."""
    try:
        return TIER_MODES[accuracy]
    except KeyError:
        raise ValueError(f"unknown accuracy tier {accuracy!r}; choose from "
                         f"{list(TIERS)}") from None


def config_for_mode(config, mode: str):
    """The config a precision mode runs: only ``compute_dtype``,
    ``corr_dtype`` and ``corr_quant`` change, so every mode shares the base
    model's architecture, backends and weights."""
    numerics = {"fp32": ("float32", "float32", False),
                "bf16": ("bfloat16", "bfloat16", False),
                "int8": ("bfloat16", "bfloat16", True)}
    if mode not in numerics:
        raise ValueError(f"unknown precision mode {mode!r}; choose from "
                         f"{list(MODES)}")
    compute, corr, q = numerics[mode]
    return dataclasses.replace(config, compute_dtype=compute,
                               corr_dtype=corr, corr_quant=q)


def default_mode(config) -> str:
    """The precision mode of a config's own requests (those without an
    ``accuracy`` field): its tier mode where the config IS that mode's
    (``config_for_mode`` round-trips), else the distinct ``"base"``, so a
    numeric mix that matches no tier never answers for one."""
    mode = ("int8" if config.corr_quant else
            "bf16" if config.compute_dtype == "bfloat16" else "fp32")
    return mode if config_for_mode(config, mode) == config else "base"


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with one scale per row (the LAST axis
    is the feature axis).  Returns ``(q, scale)``: ``q`` int8 in [-127,
    127], ``scale`` fp32 of ``x.shape[:-1]`` with ``q * scale ~= x``;
    all-zero rows get scale 1.0.  Both divisions are true divisions by
    tensors (a CUDA division by a scalar multiplies by its reciprocal);
    ``torch.round`` rounds half to even, as ``jnp.round``."""
    f = x.float()
    amax = f.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.round(f / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def inv_sqrt_channels(c: int) -> float:
    """1/sqrt(C) in fp32, as the JAX epilogue forms it on the host."""
    return float(np.float32(1.0) / np.float32(np.sqrt(np.float32(c))))


def dequant_epilogue(acc: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor,
                     c: int) -> torch.Tensor:
    """``(acc * (s1 (x) s2)) * inv`` on the int32 accumulator (B, H, W1,
    W2): multiplies only, in the JAX package's association."""
    deq = acc.float() * (s1[..., :, None] * s2[..., None, :])
    return deq * inv_sqrt_channels(c)


def int8_volume_plain(q1: torch.Tensor, s1: torch.Tensor, q2: torch.Tensor,
                      s2: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: the exact integer product, then the
    epilogue in fp32, rounded once to ``out_dtype`` (fp32 or bf16).
    ``torch.matmul`` of int8 tensors returns int8 and wraps, so the
    operands are cast first: int32 on the CPU; float64 on the card, where
    the matrix product has no integer form (exact here: |acc| <= 127^2 * C
    < 2^53).  (B, H, W1, C) x (B, H, W2, C) -> (B, H, W1, W2)."""
    wide = torch.float64 if q1.is_cuda else torch.int32
    acc = torch.matmul(q1.to(wide), q2.to(wide).transpose(-1, -2))
    if wide is torch.float64:
        acc = acc.to(torch.int32)
    return dequant_epilogue(acc, s1, s2, q1.shape[-1]).to(out_dtype)


def int8_corr_volume(q1: torch.Tensor, s1: torch.Tensor, q2: torch.Tensor,
                     s2: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Int8 volume with its dequant epilogue in ``out_dtype`` (fp32 or
    bf16): the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (counted in ``int8_corr_volume.launches``)."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_corr_volume writes float32 or bfloat16, not "
                         f"{out_dtype}")
    tensors = (q1, s1, q2, s2)
    if all(t.device.type == "cpu" for t in tensors):
        return int8_volume_plain(q1, s1, q2, s2, out_dtype)
    dev = q1.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"int8_corr_volume: tensors on "
                         f"{[t.device for t in tensors]}; all must be on one "
                         f"CUDA device")
    if q1.dtype != torch.int8 or q2.dtype != torch.int8:
        raise ValueError("int8_corr_volume takes int8 q1 and q2")
    if s1.dtype != torch.float32 or s2.dtype != torch.float32:
        raise ValueError("int8_corr_volume takes float32 scales")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("int8_corr_volume takes contiguous tensors")
    b, h, w1, c = q1.shape
    w2 = q2.shape[2]
    if (q2.shape != (b, h, w2, c) or s1.shape != (b, h, w1)
            or s2.shape != (b, h, w2)):
        raise ValueError(f"int8_corr_volume shapes {tuple(q1.shape)}, "
                         f"{tuple(s1.shape)}, {tuple(q2.shape)}, "
                         f"{tuple(s2.shape)} do not match")
    if c % 16 or q1.data_ptr() % 16 or q2.data_ptr() % 16:
        raise ValueError(f"int8_corr_volume kernel takes C a multiple of 16 "
                         f"and 16-byte aligned features; got C={c}")
    out = torch.empty((b, h, w1, w2), dtype=out_dtype, device=dev)
    lib = _build.load("int8_volume")
    fn = (lib.int8_volume_forward if out_dtype == torch.float32
          else lib.int8_volume_forward_bf16)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_long]
                   + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q1.data_ptr(), q2.data_ptr(), s1.data_ptr(), s2.data_ptr(),
                out.data_ptr(), b * h, w1, w2, c, inv_sqrt_channels(c),
                stream)
    if rc != 0:
        raise RuntimeError(f"int8_corr_volume kernel launch failed: CUDA "
                           f"error {rc}")
    int8_corr_volume.launches += 1
    return out


int8_corr_volume.launches = 0


def quant_corr_volume(fmap1: torch.Tensor, fmap2: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Quantized counterpart of ``ops.corr.build_corr_volume``: per-row
    int8 quantization of both feature maps (B, H, W, C), read in fp32 (a
    bf16 map is widened first, as the JAX package's ``_build_volume``
    does), then the int8 volume (B, H, W1, W2) in ``dtype``."""
    q1, s1 = quantize_rows(fmap1)
    q2, s2 = quantize_rows(fmap2)
    return int8_corr_volume(q1, s1, q2, s2, dtype)
