"""The fused encoder stages' backward, from the forward's saved residuals.

The counterpart of the JAX package's hand-written backward
(``raftstereo_tpu/ops/pallas_encoder.py:1107-1391``: ``_drelu``,
``_aff_stats``, ``_in_bwd_means``, ``_in_bwd``, ``_conv_bwd``,
``_stage_bwd_xla``, ``_stage_bwd_xla_affine``, ``_conv1_bwd``) and of
the layer2 references whose autodiff is layer2's backward
(``raftstereo_tpu/ops/pallas_layer2.py:423-472``), in NCHW with OIHW
weights.  The formulas are the JAX package's, literally:

* the stem + layer1 backward never re-runs a convolution forward: it
  rebuilds each normalized tensor from the saved raw conv output and its
  prep affine (instance norm: x_hat = (c - mean) * rstd with mean =
  -t/s, rstd = s; frozen batch norm: z = c*s + t), masks with ``drelu``,
  and transposes the convolutions (``torch.ops.aten.convolution_backward``,
  cuDNN on the card: the JAX package leaves these transposes to XLA,
  outside any Pallas kernel);
* the instance-norm VJP takes its two per-plane means through
  ``cuda_encoder.dual_sums`` (row 14, ``csrc/enc_stats.cu``);
* layer2's backward differentiates its plain reference (centred
  instance norm, ``torch.maximum`` relus), re-run under autograd.

bf16 (training the fused encoder with ``compute_dtype="bfloat16"``)
follows the JAX package's rounding points literally
(``_stage_bwd_xla`` :1243, ``_stage_bwd_xla_affine`` :1301, ``_conv1_bwd``
:1367; ``pallas_layer2._bwd_l2`` :485): the elementwise chain stays in
the storage dtype, each operation rounded; the fp32 statistics and
affines are cast to it at use; the instance-norm VJP's two means are fp32
sums of the bf16 values (row 14's bf16 form); the convolutions transpose
in bf16 with the weights cast to bf16, their weight gradients widened to
the parameters' fp32 and their bias gradients fp32 sums of ``dy``; the
affine gradients are fp32 sums of bf16 products.  No fp32 copy of an
activation is made: at the training recipe one such tensor
(12x64x320x720) would take 708 MB.  layer2's bf16 reference is the JAX
one at bf16: convolutions rounded to bf16 before a bf16 bias add
(``bf16.conv_bf16``), and the centred instance norm in fp32 with
its output rounded to bf16 (``pallas_norm._xla_instance_norm``).

Ties: ``jnp.maximum(z, 0)`` has derivative 0.5 at z == 0 in JAX;
``drelu`` and the references' ``torch.maximum`` keep that convention
(``F.relu`` would give 0).  It decides a gradient where a pre-activation
is exactly 0, e.g. in a frozen batch norm's dead channel (s = t = 0).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import bf16
from . import cuda_encoder as ce
from .cuda_encoder import Affine

Params = Dict[str, Tuple[torch.Tensor, torch.Tensor]]
Grads = List[Tuple[torch.Tensor, torch.Tensor]]


def drelu(z: torch.Tensor) -> torch.Tensor:
    """Derivative of max(z, 0) under JAX's tie convention: 1 above 0, 0
    below, 0.5 at z == 0 (and at NaN)."""
    return torch.where(z > 0, 1.0, torch.where(z < 0, 0.0, 0.5)).to(z.dtype)


def aff_stats(st: Affine) -> Tuple[torch.Tensor, torch.Tensor]:
    """An instance-norm prep affine (s, t), each (B, C), as broadcastable
    (mean, rstd), each (B, C, 1, 1): s is rstd (> 0: the rsqrt of
    var + 1e-5) and t = -mean * rstd."""
    s, t = st
    rstd = s[:, :, None, None]
    return -t[:, :, None, None] / rstd, rstd


def in_bwd_means(u: torch.Tensor, xhat: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean_HW(u), mean_HW(u * xhat)), each (B, C, 1, 1) fp32."""
    s1, s2 = ce.dual_sums(u.contiguous(), xhat.contiguous())
    n = float(u.shape[2] * u.shape[3])
    return (s1 / n)[:, :, None, None], (s2 / n)[:, :, None, None]


def in_bwd(xhat: torch.Tensor, rstd: torch.Tensor,
           u: torch.Tensor) -> torch.Tensor:
    """VJP of x -> xhat = (x - mean(x)) * rstd(x) through the per-image
    statistics: dx = rstd * (u - mean_HW(u) - xhat * mean_HW(u * xhat)),
    in ``u``'s dtype with the fp32 means and ``rstd`` cast to it."""
    mu, mux = in_bwd_means(u, xhat)
    dt = u.dtype
    return rstd.to(dt) * (u - mu.to(dt) - xhat * mux.to(dt))


def conv_bwd(t: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
             stride: int = 1, need_input: bool = True):
    """(dt or None, dweight, dbias) of y = conv(t, weight) + bias with
    padding k // 2, by transposition alone (no primal evaluation): the
    stage's 3x3 convs, and conv1's 7x7 at stride 1 or 2
    (``_conv1_bwd``).  The transposes run in ``dy``'s dtype with the
    weight cast to it; dweight comes back in the weight's dtype and dbias
    is an fp32 sum of ``dy``."""
    cout, _, k, _ = weight.shape
    pad = k // 2
    dt, dw, _ = torch.ops.aten.convolution_backward(
        dy, t, weight.to(dy.dtype), [cout], [stride, stride], [pad, pad],
        [1, 1], False, [0, 0], 1, [need_input, True, False])
    return dt, dw.to(weight.dtype), dy.sum(dim=(0, 2, 3), dtype=torch.float32)


def stage_bwd(y1: torch.Tensor, raws: Sequence[torch.Tensor],
              affs: Sequence[Affine], weights: Sequence[torch.Tensor],
              g: torch.Tensor) -> Tuple[torch.Tensor, Grads]:
    """Backward of the instance-norm stem + layer1 stage
    (``_stage_bwd_xla``): from conv1's raw output ``y1``, the raw c10,
    c11, c20, c21, the five prep affines, the four convs' weights and the
    output cotangent ``g``, returns (dy1, [(dweight, dbias)] in conv
    order)."""
    cdt = y1.dtype
    c10, c11, c20, c21 = raws
    w10, w11, w20, w21 = weights
    stats = [(m.to(cdt), r.to(cdt)) for m, r in map(aff_stats, affs)]
    r1, r10, r11, r20, r21 = [s[1] for s in stats]

    def nh(c, st):
        m, r = st
        return (c - m) * r

    x0 = nh(y1, stats[0])
    t0 = torch.clamp(x0, min=0)
    x10 = nh(c10, stats[1])
    t10 = torch.clamp(x10, min=0)
    x11 = nh(c11, stats[2])
    z1 = t0 + torch.clamp(x11, min=0)
    t1 = torch.clamp(z1, min=0)
    x20 = nh(c20, stats[3])
    t20 = torch.clamp(x20, min=0)
    x21 = nh(c21, stats[4])

    go = g.to(cdt) * drelu(t1 + torch.clamp(x21, min=0))
    dc21 = in_bwd(x21, r21, go * drelu(x21))
    dt20, dk21, db21 = conv_bwd(t20, w21, dc21)
    dc20 = in_bwd(x20, r20, dt20 * drelu(x20))
    dt1c, dk20, db20 = conv_bwd(t1, w20, dc20)
    dz1 = (go + dt1c) * drelu(z1)
    dc11 = in_bwd(x11, r11, dz1 * drelu(x11))
    dt10, dk11, db11 = conv_bwd(t10, w11, dc11)
    dc10 = in_bwd(x10, r10, dt10 * drelu(x10))
    dt0c, dk10, db10 = conv_bwd(t0, w10, dc10)
    dy1 = in_bwd(x0, r1, (dz1 + dt0c) * drelu(x0))
    return dy1, [(dk10, db10), (dk11, db11), (dk20, db20), (dk21, db21)]


def stage_bwd_affine(y1: torch.Tensor, raws: Sequence[torch.Tensor],
                     weights: Sequence[torch.Tensor],
                     affines: Sequence[Affine], g: torch.Tensor
                     ) -> Tuple[torch.Tensor, Grads, List[Affine]]:
    """Backward of the frozen-batch-norm stage (``_stage_bwd_xla_affine``)
    with (C,) affines [norm1, layer1_0.norm1, layer1_0.norm2,
    layer1_1.norm1, layer1_1.norm2]: returns (dy1, [(dweight, dbias)] in
    conv order, [(ds, dt)] per affine), the affine gradients summed over
    (B, H, W) per channel."""
    cdt = y1.dtype
    c10, c11, c20, c21 = raws
    w10, w11, w20, w21 = weights
    aff = [(s.to(cdt)[None, :, None, None], t.to(cdt)[None, :, None, None])
           for s, t in affines]

    def pre(c, i):
        s, t = aff[i]
        return c * s + t

    z0 = pre(y1, 0)
    t0 = torch.clamp(z0, min=0)
    z10 = pre(c10, 1)
    t10 = torch.clamp(z10, min=0)
    z11 = pre(c11, 2)
    z1 = t0 + torch.clamp(z11, min=0)
    t1 = torch.clamp(z1, min=0)
    z20 = pre(c20, 3)
    t20 = torch.clamp(z20, min=0)
    z21 = pre(c21, 4)

    daff: List[Affine] = [None] * 5

    def aff_bwd(dact, z, c, i):
        u = dact * drelu(z)
        daff[i] = ((u * c).sum((0, 2, 3), dtype=torch.float32),
                   u.sum((0, 2, 3), dtype=torch.float32))
        return u * aff[i][0]

    go = g.to(cdt) * drelu(t1 + torch.clamp(z21, min=0))
    dc21 = aff_bwd(go, z21, c21, 4)
    dt20, dk21, db21 = conv_bwd(t20, w21, dc21)
    dc20 = aff_bwd(dt20, z20, c20, 3)
    dt1c, dk20, db20 = conv_bwd(t1, w20, dc20)
    dz1 = (go + dt1c) * drelu(z1)
    dc11 = aff_bwd(dz1, z11, c11, 2)
    dt10, dk11, db11 = conv_bwd(t10, w11, dc11)
    dc10 = aff_bwd(dt10, z10, c10, 1)
    dt0c, dk10, db10 = conv_bwd(t0, w10, dc10)
    dy1 = aff_bwd(dz1 + dt0c, z0, y1, 0)
    return dy1, [(dk10, db10), (dk11, db11), (dk20, db20), (dk21, db21)], daff


# ----------------------------------------------- layer2 references

def _conv(x, wb, stride=1):
    w, b = wb
    if x.dtype == torch.bfloat16:
        return bf16.conv_bf16(x, w, b, stride, w.shape[-1] // 2)
    return F.conv2d(x, w, b, stride, w.shape[-1] // 2)


def _relu(x):
    """max(x, 0) with JAX's 0.5 derivative at a tie."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


class _CentredNormBf16(torch.autograd.Function):
    """``pallas_norm._xla_instance_norm`` (no relu) on bf16 NCHW ``x``: x
    upcast, the mean and the mean of centred squares in fp32, the output
    rounded to bf16; with the VJP that ``jax.vjp`` gives it, op for op.
    JAX upcasts x twice (for the mean and for the centring), so its
    cotangent reaches x along two paths, each rounded to bf16 on its own
    and then added in bf16; autograd through one upcast would round their
    fp32 sum once.  Means divide by a device tensor: torch turns a
    division by a Python number into a product with its reciprocal on the
    card, which rounds differently."""

    @staticmethod
    def forward(ctx, x):
        n = torch.full((), float(x.shape[2] * x.shape[3]), device=x.device)
        xf = x.float()
        m = xf.sum((2, 3), keepdim=True) / n
        h = xf - m
        var = (h * h).sum((2, 3), keepdim=True) / n + 1e-5
        rstd = torch.rsqrt(var)
        ctx.save_for_backward(x, m, var, rstd, n)
        return (h * rstd).to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        x, m, var, rstd, n = ctx.saved_tensors
        h = x.float() - m
        g = gy.float()
        dvar = (h * g).sum((2, 3), keepdim=True) * (-0.5 * (rstd / var)) / n
        dh = g * rstd + dvar * (2.0 * h)
        dm = (-dh).sum((2, 3), keepdim=True) / n
        return dh.to(x.dtype) + dm.to(x.dtype)


class _AffineBf16(torch.autograd.Function):
    """``x * s + t`` in bf16 for NCHW ``x`` and fp32 (C,) ``s``, ``t`` cast
    at use, each op rounded, with JAX's transposes: the cotangents of s
    and t are bf16 sums over the batch and pixels (``bf16.sum32``) of
    ``dy * x`` and ``dy``, widened to fp32 through the casts."""

    @staticmethod
    def forward(ctx, x, s, t):
        sb = s.to(x.dtype)[:, None, None]
        ctx.save_for_backward(x, sb)
        return x * sb + t.to(x.dtype)[:, None, None]

    @staticmethod
    def backward(ctx, dy):
        x, sb = ctx.saved_tensors
        return (dy * sb,
                bf16.sum32(dy * x, (0, 2, 3)).reshape(-1).float(),
                bf16.sum32(dy, (0, 2, 3)).reshape(-1).float())


def instance_norm(x: torch.Tensor, relu: bool) -> torch.Tensor:
    """The centred instance norm of ``pallas_norm._xla_instance_norm``:
    mean, then the mean of centred squares, eps 1e-5, in fp32; a bf16
    ``x`` is upcast and the normalised output rounded to bf16 before the
    relu (``_CentredNormBf16``)."""
    if x.dtype == torch.bfloat16:
        y = _CentredNormBf16.apply(x)
    else:
        m = x.mean(dim=(2, 3), keepdim=True)
        c = x - m
        v = (c * c).mean(dim=(2, 3), keepdim=True)
        y = c * torch.rsqrt(v + 1e-5)
    return _relu(y) if relu else y


def layer2_reference(t_in: torch.Tensor, params: Params) -> torch.Tensor:
    """Plain layer2, instance norm (``_xla_layer2_reference``)."""
    c1 = _conv(t_in, params["c1"], 2)
    u2 = instance_norm(_conv(instance_norm(c1, True), params["c2"]), True)
    pn = instance_norm(_conv(t_in, params["proj"], 2), False)
    out0 = _relu(pn + u2)
    c3 = _conv(out0, params["c3"])
    y4 = instance_norm(_conv(instance_norm(c3, True), params["c4"]), True)
    return _relu(out0 + y4)


def layer2_reference_affine(t_in: torch.Tensor, params: Params,
                            affines: Sequence[Affine]) -> torch.Tensor:
    """Plain frozen-batch-norm layer2 (``_xla_layer2_reference_affine``);
    (C,) affines [norm1, projection norm, norm2, layer2_1.norm1,
    layer2_1.norm2]."""
    def nr(x, i, relu=True):
        s, t = affines[i]
        if x.dtype == torch.bfloat16:
            y = _AffineBf16.apply(x, s, t)
        else:
            y = x * s[:, None, None] + t[:, None, None]
        return _relu(y) if relu else y

    c1 = _conv(t_in, params["c1"], 2)
    u2 = nr(_conv(nr(c1, 0), params["c2"]), 2)
    pn = nr(_conv(t_in, params["proj"], 2), 1, relu=False)
    out0 = _relu(pn + u2)
    c3 = _conv(out0, params["c3"])
    y4 = nr(_conv(nr(c3, 3), params["c4"]), 4)
    return _relu(out0 + y4)
