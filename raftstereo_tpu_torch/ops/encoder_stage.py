"""The fused encoder stages: stem + layer1 and layer2, composed from the
kernels of ``ops.cuda_encoder`` in the JAX package's order of operations
(``raftstereo_tpu/ops/pallas_encoder.py`` ``_fused_forward1`` :919,
``_fused_forward1_affine`` :1071, ``_stage_on_packed`` :556;
``raftstereo_tpu/ops/pallas_layer2.py`` ``_fused_layer2_fwd`` :378).

Each stage keeps its activations RAW (the conv outputs with their bias)
and carries every norm as a prep affine (s, t) applied inside the next
kernel as relu(x*s + t):

* instance norm: the affine comes from the conv kernel's own fp32 output
  sums, ``in_affine`` (the fused stages' E[x^2] - mean^2 form, not the
  plain ``InstanceNorm``'s centred one);
* frozen batch norm: the constant folded affine ``bn_affine``, and the
  kernels compute no sums.

The stages compute in their input's dtype: a bf16 image or activation
runs the kernels' bf16 forms with the fp32 parameters cast at use, the
affines and sums staying fp32 (``ops.cuda_encoder``), and returns a bf16
output; its backward then runs in bf16 with the JAX package's rounding
points (``ops.encoder_bwd``).

Tensors are NCHW; ``params`` map a conv's name to ``(weight, bias)`` with
OIHW weights (``c10, c11, c20, c21`` for layer1; ``c1, proj, c2, c3, c4``
for layer2); ``affines`` are five (C,) pairs in the JAX package's stage
order.  The space-sharding plumbing of the JAX stages (``_shard_ctx``,
``_shard_wrapped``, halo exchange) is not ported (ROADMAP Queue 1 item
10).

Each entry point is a ``torch.autograd.Function`` with the JAX package's
custom VJP (``ops.encoder_bwd``): the stem + layer1 stages save what the
JAX ``_fwd*`` save (conv1's raw output, the four raw conv outputs, the
instance-norm prep affines; the image for conv1) and differentiate from
them without re-running a forward (``_bwd1``, ``_bwd``, ``_bwd_bn``,
``_bwd1_bn``); layer2 saves its input and parameters and differentiates
its plain reference, re-run in the backward (``_bwd_l2``,
``_bwd_l2_bn``).  Gradients reach the frozen batch norms' weight and
bias through the (C,) affines (``bn_affine`` is differentiable).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from . import cuda_encoder as ce
from . import encoder_bwd as eb
from .cuda_encoder import Affine

Params = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def in_affine(sums: Tuple[torch.Tensor, torch.Tensor], n: float) -> Affine:
    """Instance-norm prep affine from fp32 output sums over ``n`` pixels:
    mean = s1/n, var = max(s2/n - mean^2, 0), rstd = rsqrt(var + 1e-5),
    affine (rstd, -mean*rstd) (``pallas_encoder.stats_from_packed`` and
    ``_expand_stats``; ``pallas_layer2._flat_affine``)."""
    s1, s2 = sums
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + 1e-5)
    return rstd, -mean * rstd


def bn_affine(weight: torch.Tensor, bias: torch.Tensor,
              running_mean: torch.Tensor, running_var: torch.Tensor,
              eps: float = 1e-5) -> Affine:
    """Frozen batch norm folded to the prep affine: s = gamma *
    rsqrt(var + eps), t = beta - mean * s (``pallas_encoder.bn_affine``;
    exact for gamma == 0 channels too).  Returns (C,) tensors."""
    s = weight * torch.rsqrt(running_var + eps)
    return s, bias - running_mean * s


def _per_image(affines: Sequence[Affine], b: int):
    """(C,) affines -> (B, C), the kernels' per-(image, channel) form."""
    return [(s.expand(b, -1).contiguous(), t.expand(b, -1).contiguous())
            for s, t in affines]


def _stage(y1: torch.Tensor, st1: Affine, params: Params, n: float,
           affines: Optional[Sequence[Affine]] = None):
    """The four layer1 convs and the finish from conv1's raw output ``y1``
    and its prep affine ``st1``.  ``affines``: the four remaining
    per-image affines of a batch-norm stage (then no sums are taken).
    Returns (output, the raw c10, c11, c20, c21, the five prep affines):
    the stage's backward residuals."""
    ws = affines is None

    def nxt(sums, i):
        return in_affine(sums, n) if ws else affines[i]

    c10, s = ce.stage_conv(y1, st1, *params["c10"], want_stats=ws)
    st10 = nxt(s, 0)
    c11, s = ce.stage_conv(c10, st10, *params["c11"], want_stats=ws)
    st11 = nxt(s, 1)
    # Block boundary: layer1_1.conv1's input is relu(t0 + u2).
    c20, s = ce.stage_conv(c11, st11, *params["c20"], res=y1, res_aff=st1,
                           want_stats=ws)
    st20 = nxt(s, 2)
    c21, s = ce.stage_conv(c20, st20, *params["c21"], want_stats=ws)
    st21 = nxt(s, 3)
    out = ce.stage_finish(y1, st1, c11, st11, c21, st21)
    return out, (c10, c11, c20, c21), (st1, st10, st11, st20, st21)


def _conv1(stride: int):
    return ce.stem_conv7_s2 if stride == 2 else ce.stem_conv7


_STAGE_CONVS = ("c10", "c11", "c20", "c21")


def _flat(pairs) -> list:
    return [t for pair in pairs for t in pair]


def _pairs(ts) -> list:
    return [(ts[i], ts[i + 1]) for i in range(0, len(ts), 2)]


class _Stem(torch.autograd.Function):
    """stem + layer1 with the JAX package's saved-residual backward.
    ``stride`` None: ``x`` is conv1's raw output; 1 or 2: ``x`` is the
    image and the first two of ``ts`` are conv1's weight and bias.  Then
    the four layer1 convs' (weight, bias), then for ``bn`` the five (C,)
    affines' (s, t)."""

    @staticmethod
    def forward(ctx, stride, bn, x, *ts):
        k = 2 if stride else 0
        params = dict(zip(_STAGE_CONVS, _pairs(ts[k:k + 8])))
        affines = _pairs(ts[k + 8:]) if bn else None
        if stride:
            y1, sums = _conv1(stride)(x, ts[0], ts[1], want_stats=not bn)
        else:
            y1 = x
            sums = None if bn else ce.plane_stats(y1)
        if bn:
            aff = _per_image(affines, y1.shape[0])
            out, raws, _ = _stage(y1, aff[0], params, 1.0, aff[1:])
            kept = _flat(affines)
        else:
            n = float(y1.shape[2] * y1.shape[3])
            out, raws, affs = _stage(y1, in_affine(sums, n), params, n)
            kept = _flat(affs)
        ctx.stride, ctx.bn = stride, bn
        weights = [params[name][0] for name in _STAGE_CONVS]
        ctx.save_for_backward(x, y1, *raws, *weights, *ts[:k:2], *kept)
        return out

    @staticmethod
    def backward(ctx, g):
        stride, bn = ctx.stride, ctx.bn
        x, y1, *rest = ctx.saved_tensors
        raws, weights, rest = rest[:4], rest[4:8], rest[8:]
        if stride:
            w1, *rest = rest
        kept = _pairs(rest)
        daff = []
        if bn:
            dy1, dparams, daff = eb.stage_bwd_affine(y1, raws, weights,
                                                     kept, g)
        else:
            dy1, dparams = eb.stage_bwd(y1, raws, kept, weights, g)
        head = []
        if stride:  # conv1 (``_conv1_bwd``)
            dx, dw1, db1 = eb.conv_bwd(x, w1, dy1, stride,
                                       ctx.needs_input_grad[2])
            head = [dw1, db1]
        else:
            dx = dy1
        return (None, None, dx, *head, *_flat(dparams), *_flat(daff))


def _stage_params(params: Params) -> list:
    return _flat(params[name] for name in _STAGE_CONVS)


def conv1_stem_layer1(img: torch.Tensor, c1: Tuple[torch.Tensor,
                                                   torch.Tensor],
                      params: Params, stride: int = 1) -> torch.Tensor:
    """conv1 + norm1 + relu + layer1, instance norm, from the (B, 3, H, W)
    normalized image (stride 2 needs H % 2 == 0 and W % 4 == 0, as on the
    TPU).  Statistics span conv1's output."""
    return _Stem.apply(stride, False, img, *c1, *_stage_params(params))


def stem_layer1(y1: torch.Tensor, params: Params) -> torch.Tensor:
    """norm1 + relu + layer1, instance norm, from conv1's raw output
    computed elsewhere: its sums come from the stats kernel."""
    return _Stem.apply(None, False, y1, *_stage_params(params))


def bn_stem_layer1(y1: torch.Tensor, params: Params,
                   affines: Sequence[Affine]) -> torch.Tensor:
    """The batch-norm stage from conv1's raw output; ``affines`` [norm1,
    layer1_0.norm1, layer1_0.norm2, layer1_1.norm1, layer1_1.norm2]."""
    return _Stem.apply(None, True, y1, *_stage_params(params),
                       *_flat(affines))


def bn_conv1_stem_layer1(img: torch.Tensor,
                         c1: Tuple[torch.Tensor, torch.Tensor],
                         params: Params, affines: Sequence[Affine],
                         stride: int = 1) -> torch.Tensor:
    """conv1 (no sums) + the batch-norm stage."""
    return _Stem.apply(stride, True, img, *c1, *_stage_params(params),
                       *_flat(affines))


def _layer2(t_in: torch.Tensor, params: Params,
            affines: Optional[Sequence[Affine]] = None) -> torch.Tensor:
    ws = affines is None
    n = float((t_in.shape[2] // 2) * (t_in.shape[3] // 2))
    aff = None if ws else _per_image(affines, t_in.shape[0])

    def nxt(sums, i):
        return in_affine(sums, n) if ws else aff[i]

    c1, p, s1, sp = ce.l2_entry(t_in, *params["c1"], *params["proj"],
                                want_stats=ws)
    a1, ap = nxt(s1, 0), nxt(sp, 1)
    c2, s = ce.l2_conv(c1, a1, *params["c2"], want_stats=ws)
    a2 = nxt(s, 2)
    c3, s = ce.l2_conv(c2, a2, *params["c3"], res=p, res_aff=ap,
                       want_stats=ws)
    a3 = nxt(s, 3)
    c4, s = ce.l2_conv(c3, a3, *params["c4"], want_stats=ws)
    a4 = nxt(s, 4)
    return ce.l2_finish(p, ap, c2, a2, c4, a4)


_L2_CONVS = ("c1", "proj", "c2", "c3", "c4")


class _Layer2(torch.autograd.Function):
    """layer2 with the JAX package's backward: the VJP of the plain
    reference, re-run from the saved input and parameters.  ``ts``: the
    five convs' (weight, bias) in ``_L2_CONVS`` order, then for ``bn``
    the five (C,) affines' (s, t)."""

    @staticmethod
    def forward(ctx, bn, t_in, *ts):
        ctx.bn = bn
        ctx.save_for_backward(t_in, *ts)
        params = dict(zip(_L2_CONVS, _pairs(ts[:10])))
        return _layer2(t_in, params, _pairs(ts[10:]) if bn else None)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            xs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            params = dict(zip(_L2_CONVS, _pairs(xs[1:11])))
            if ctx.bn:
                out = eb.layer2_reference_affine(xs[0], params,
                                                 _pairs(xs[11:]))
            else:
                out = eb.layer2_reference(xs[0], params)
            grads = torch.autograd.grad(out, xs, g)
        return (None, *grads)


def fused_layer2(t_in: torch.Tensor, params: Params) -> torch.Tensor:
    """layer2 (two ResidualBlocks, the first stride 2 with a 1x1
    projection), instance norm, from the stage activation (B, 64, H, W),
    even H and W: (B, 96, H/2, W/2)."""
    return _Layer2.apply(False, t_in, *_flat(params[n] for n in _L2_CONVS))


def fused_layer2_bn(t_in: torch.Tensor, params: Params,
                    affines: Sequence[Affine]) -> torch.Tensor:
    """Batch-norm layer2; ``affines`` [norm1, projection norm, norm2,
    layer2_1.norm1, layer2_1.norm2]."""
    return _Layer2.apply(True, t_in, *_flat(params[n] for n in _L2_CONVS),
                         *_flat(affines))
