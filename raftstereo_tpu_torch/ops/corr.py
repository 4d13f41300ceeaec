"""Correlation backends: the per-pair state and the per-iteration lookup.

The counterpart of the JAX package's ``ops/corr.py`` (``build_corr_state``
/ ``corr_fn_from_state``), with its four backends:

* ``pallas_alt`` — on-demand: fmap2 is average-pooled along W by 2 per
  level with floor halving, and each lookup recomputes only the
  correlation taps it needs (CUDA kernels ``csrc/alt_corr.cu`` and
  ``csrc/alt_corr_bwd.cu``, ``ops.cuda_alt``).
* ``alt`` — the same state, looked up in plain PyTorch: fmap2 sampled at
  the taps, then dotted with fmap1 (the JAX package's ``_alt_lookup``).
* ``pallas`` — the volume (or, with ``corr_quant``, the int8 volume of
  ``ops.quant``) built once per pair in ``corr_dtype``, its W2 pyramid,
  and one lookup over all levels per iteration (CUDA kernels
  ``csrc/corr_vol.cu`` and ``csrc/corr_vol_bwd.cu``, ``ops.cuda_vol``).
* ``reg`` — the same state, looked up in plain PyTorch with
  ``ops.sampler.linear_sample_1d`` (the JAX package's ``_reg_lookup``).

The TPU forms pad every level to 128 lanes, W1 to the row block and rows
to 8; here the levels are concatenated at their real widths and nothing
is padded, which is the same function (the TPU's padded columns
contribute exactly zero).  Every fp32 lookup is differentiable: the
kernels' VJPs are the backward kernels, and gradients reach fmap1 and
fmap2 through the pooling, the volume product and the concat by ordinary
autograd.

bf16: the ``pallas_alt`` state stores fmap1 and the fmap2 pyramid in
``corr_dtype``, pooled in fp32 first and rounded after, and the lookup
emits the compute dtype (``out_dtype``); with grad enabled it is the
differentiable lookup in every dtype (bf16 training), under inference
the kernel alone.  The ``pallas`` state stores its volume in
``corr_dtype``: rounded once from the fp32 product (or the int8
epilogue), then each level pooled from the previous bf16 one with an fp32
sum, as the JAX package's ``build_corr_pyramid`` does on a bf16 volume;
its lookup reads bf16 and emits fp32 features, cast to ``out_dtype``.
``reg`` and ``alt`` build and look up in fp32 and cast the features, as
the JAX package's ``make_corr_fn`` does.  ``corr_lookup_epi`` is the
lookup with the motion encoder's convc1 fused in (``ops.cuda_alt.alt_corr_epi``), for
``pallas_alt`` states: the JAX package's ``corr_epilogue_active`` rule.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from ..config import CORR_IMPLEMENTATIONS
from .cuda_alt import alt_corr, alt_corr_autograd, alt_corr_epi
from .cuda_vol import level_taps, vol_lookup_autograd
from .quant import quant_corr_volume
from .sampler import linear_sample_1d


def resolve_implementation(implementation: str, quant: bool = False) -> str:
    """The backend a config runs: the JAX rule on its accelerator.
    ``quant`` (the int8 volume) overrides the configured backend with the
    precomputed-volume kernel backend, ``pallas``; ``auto`` is the
    on-demand kernel backend, ``pallas_alt``.  The rule does not depend on
    the device: on the CPU the same path runs the kernels' plain
    versions."""
    if quant:
        return "pallas"
    if implementation == "auto":
        return "pallas_alt"
    if implementation not in CORR_IMPLEMENTATIONS:
        raise ValueError(f"unknown corr implementation: {implementation}")
    return implementation


def build_corr_volume(fmap1: torch.Tensor, fmap2: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W1, C) x (B, H, W2, C) -> (B, H, W1, W2), scaled by
    1/sqrt(C), in ``dtype`` (rounded once from fp32): one batched fp32
    matmul over B*H rows, as the JAX package leaves it to XLA outside any
    kernel.  On the card it runs in full fp32 (TF32 off:
    ``device.fp32_numerics``, set by the model)."""
    c = fmap1.shape[-1]
    corr = torch.matmul(fmap1.float(), fmap2.float().transpose(-1, -2))
    return (corr / torch.full((), float(c), device=corr.device).sqrt()
            ).to(dtype)


def build_corr_pyramid(corr: torch.Tensor,
                       num_levels: int) -> List[torch.Tensor]:
    """Average-pool the W2 axis by 2 per level, floor-halving odd widths.
    A bf16 level is pooled from the previous bf16 level: the pair widened,
    summed and halved in fp32, rounded once (``jnp.mean`` on bf16)."""
    pyramid = [corr]
    for _ in range(num_levels - 1):
        c = pyramid[-1]
        w2 = c.shape[-1] // 2
        pairs = c[..., :2 * w2].reshape(*c.shape[:-1], w2, 2)
        if c.dtype == torch.bfloat16:
            pairs = pairs.float()
            pooled = ((pairs[..., 0] + pairs[..., 1]) * 0.5).to(c.dtype)
        else:
            pooled = pairs.mean(dim=-1)
        pyramid.append(pooled)
    return pyramid


def build_fmap2_pyramid(fmap2: torch.Tensor,
                        num_levels: int) -> List[torch.Tensor]:
    """Pool fmap2 (B, H, W, C) along W by 2 per level, floor-halving."""
    b, h, _, c = fmap2.shape
    pyramid = [fmap2]
    for _ in range(num_levels - 1):
        f2 = pyramid[-1]
        w = f2.shape[2] // 2
        pyramid.append(f2[:, :, :2 * w].reshape(b, h, w, 2, c).mean(dim=3))
    return pyramid


class CorrState(NamedTuple):
    """Per-pair lookup state of one resolved backend.

    On-demand backends ("alt", "pallas_alt"): ``fmap1`` (B, H, W1, C) and
    ``f2cat``, the fmap2 pyramid concatenated along W at its real level
    widths (B, H, sum(widths), C).  Precomputed-volume backends ("reg",
    "pallas"): ``vcat``, the volume pyramid concatenated along W2 at its
    real level widths (B, H, W1, sum(widths)).  ``widths`` are the level
    widths."""

    fmap1: Optional[torch.Tensor]
    f2cat: Optional[torch.Tensor]
    widths: Tuple[int, ...]
    backend: str = "pallas_alt"
    vcat: Optional[torch.Tensor] = None


def build_corr_state(fmap1: torch.Tensor, fmap2: torch.Tensor,
                     num_levels: int, implementation: str = "pallas_alt",
                     quant: bool = False,
                     corr_dtype: torch.dtype = torch.float32) -> CorrState:
    """Build the lookup state once per pair (contiguous) for the backend
    ``resolve_implementation(implementation, quant)``.  ``quant`` builds
    the int8 volume; the caller passes it in test mode only.  The
    ``pallas_alt`` state (pooled in fp32 first) and the ``pallas`` volume
    pyramid (pooled level by level) are stored in ``corr_dtype``; the
    ``reg`` and ``alt`` states are fp32."""
    backend = resolve_implementation(implementation, quant)
    if backend in ("reg", "pallas"):
        dt = corr_dtype if backend == "pallas" else torch.float32
        volume = (quant_corr_volume(fmap1, fmap2, dt) if quant
                  else build_corr_volume(fmap1, fmap2, dt))
        pyr = build_corr_pyramid(volume, num_levels)
        return CorrState(None, None, tuple(p.shape[-1] for p in pyr),
                         backend, torch.cat(pyr, dim=-1).contiguous())
    pyr = build_fmap2_pyramid(fmap2.float(), num_levels)
    dt = corr_dtype if backend == "pallas_alt" else torch.float32
    return CorrState(fmap1.float().to(dt).contiguous(),
                     torch.cat(pyr, dim=2).to(dt).contiguous(),
                     tuple(p.shape[2] for p in pyr), backend)


def _levels(cat: torch.Tensor, widths, dim: int):
    off = 0
    for w in widths:
        yield cat.narrow(dim, off, w)
        off += w


def _reg_lookup(state: CorrState, x: torch.Tensor,
                radius: int) -> torch.Tensor:
    """The JAX package's ``_reg_lookup``: a gather and lerp per level."""
    return torch.cat([linear_sample_1d(vol, level_taps(x, i, radius))
                      for i, vol in enumerate(_levels(state.vcat,
                                                      state.widths, 3))],
                     dim=-1)


def _gather_rows(f2: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """fmap2 rows (B, H, w, C) at float columns ``j`` (B, H, W1, K), zero
    where ``j`` is outside [0, w-1] (tested in float, false for NaN)."""
    b, h, w, c = f2.shape
    valid = (j >= 0) & (j <= w - 1)
    zero = torch.zeros((), device=j.device)
    idx = torch.where(valid, j, zero).long().reshape(b, h, -1, 1)
    v = torch.gather(f2, 2, idx.expand(-1, -1, -1, c))
    return torch.where(valid[..., None], v.reshape(j.shape + (c,)), zero)


def _alt_lookup(state: CorrState, x: torch.Tensor,
                radius: int) -> torch.Tensor:
    """The JAX package's ``_alt_lookup``: fmap2 lerped at the taps (zero
    outside the level), then dotted with fmap1 and scaled by 1/sqrt(C)."""
    fmap1 = state.fmap1
    scale = 1.0 / float(fmap1.shape[-1]) ** 0.5
    out = []
    for i, f2 in enumerate(_levels(state.f2cat, state.widths, 2)):
        taps = level_taps(x, i, radius)                   # (B, H, W1, K)
        if f2.shape[2] == 0:
            out.append(torch.zeros_like(taps))
            continue
        x0 = torch.floor(taps)
        dx = (taps - x0)[..., None]
        f2_taps = (_gather_rows(f2, x0) * (1.0 - dx)
                   + _gather_rows(f2, x0 + 1.0) * dx)     # (B, H, W1, K, C)
        out.append(torch.matmul(f2_taps, fmap1[..., :, None])[..., 0]
                   * scale)
    return torch.cat(out, dim=-1)


def corr_lookup(state: CorrState, x: torch.Tensor, radius: int,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Correlation features at level-0 x-coordinates ``x`` (B, H, W1) by
    the state's backend: (B, H, W1, L*(2r+1)) in ``out_dtype``, channels
    level-major, taps -r..r.  With grad enabled the on-demand lookup is
    differentiable through its backward kernel, in any dtype; the lookups
    of the other backends are differentiable through autograd."""
    x = x.float().contiguous()
    if state.backend == "pallas_alt":
        lookup = alt_corr_autograd if torch.is_grad_enabled() else alt_corr
        return lookup(state.fmap1, state.f2cat, state.widths, x, radius,
                      out_dtype)
    if state.backend == "pallas":
        out = vol_lookup_autograd(state.vcat, state.widths, x, radius)
    elif state.backend == "reg":
        out = _reg_lookup(state, x, radius)
    elif state.backend == "alt":
        out = _alt_lookup(state, x, radius)
    else:
        raise ValueError(f"unknown corr backend: {state.backend}")
    return out.to(out_dtype)


def corr_lookup_epi(state: CorrState, x: torch.Tensor, radius: int,
                    w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``relu(corr_lookup(...) @ w + b)`` in bf16 through the fused
    kernel (``pallas_alt`` states only; inference): w (L*(2r+1), Co) and
    b (Co) bf16 -> (B, H, W1, Co) bf16."""
    if state.backend != "pallas_alt":
        raise ValueError(f"the fused convc1 needs the pallas_alt state, not "
                         f"{state.backend}")
    return alt_corr_epi(state.fmap1, state.f2cat, state.widths,
                        x.float().contiguous(), radius, w, b)
