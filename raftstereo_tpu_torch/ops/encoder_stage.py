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

Tensors are NCHW; ``params`` map a conv's name to ``(weight, bias)`` with
OIHW weights (``c10, c11, c20, c21`` for layer1; ``c1, proj, c2, c3, c4``
for layer2); ``affines`` are five (C,) pairs in the JAX package's stage
order.  The space-sharding plumbing of the JAX stages (``_shard_ctx``,
``_shard_wrapped``, halo exchange) is not ported (ROADMAP Queue 1 item
10).  Inference only: the stages' backward (ROADMAP Queue 2 row 14) is
not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from . import cuda_encoder as ce
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
           affines: Optional[Sequence[Affine]] = None) -> torch.Tensor:
    """The four layer1 convs and the finish from conv1's raw output ``y1``
    and its prep affine ``st1``.  ``affines``: the four remaining
    per-image affines of a batch-norm stage (then no sums are taken)."""
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
    return ce.stage_finish(y1, st1, c11, st11, c21, st21)


def _conv1(stride: int):
    return ce.stem_conv7_s2 if stride == 2 else ce.stem_conv7


def conv1_stem_layer1(img: torch.Tensor, c1: Tuple[torch.Tensor,
                                                   torch.Tensor],
                      params: Params, stride: int = 1) -> torch.Tensor:
    """conv1 + norm1 + relu + layer1, instance norm, from the (B, 3, H, W)
    normalized image (stride 2 needs H % 2 == 0 and W % 4 == 0, as on the
    TPU).  Statistics span conv1's output."""
    y1, sums = _conv1(stride)(img, *c1)
    n = float(y1.shape[2] * y1.shape[3])
    return _stage(y1, in_affine(sums, n), params, n)


def stem_layer1(y1: torch.Tensor, params: Params) -> torch.Tensor:
    """norm1 + relu + layer1, instance norm, from conv1's raw output
    computed elsewhere: its sums come from the stats kernel."""
    n = float(y1.shape[2] * y1.shape[3])
    return _stage(y1, in_affine(ce.plane_stats(y1), n), params, n)


def bn_stem_layer1(y1: torch.Tensor, params: Params,
                   affines: Sequence[Affine]) -> torch.Tensor:
    """The batch-norm stage from conv1's raw output; ``affines`` [norm1,
    layer1_0.norm1, layer1_0.norm2, layer1_1.norm1, layer1_1.norm2]."""
    aff = _per_image(affines, y1.shape[0])
    return _stage(y1, aff[0], params, 1.0, aff[1:])


def bn_conv1_stem_layer1(img: torch.Tensor,
                         c1: Tuple[torch.Tensor, torch.Tensor],
                         params: Params, affines: Sequence[Affine],
                         stride: int = 1) -> torch.Tensor:
    """conv1 (no sums) + the batch-norm stage."""
    y1, _ = _conv1(stride)(img, *c1, want_stats=False)
    return bn_stem_layer1(y1, params, affines)


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


def fused_layer2(t_in: torch.Tensor, params: Params) -> torch.Tensor:
    """layer2 (two ResidualBlocks, the first stride 2 with a 1x1
    projection), instance norm, from the stage activation (B, 64, H, W),
    even H and W: (B, 96, H/2, W/2)."""
    return _layer2(t_in, params)


def fused_layer2_bn(t_in: torch.Tensor, params: Params,
                    affines: Sequence[Affine]) -> torch.Tensor:
    """Batch-norm layer2; ``affines`` [norm1, projection norm, norm2,
    layer2_1.norm1, layer2_1.norm2]."""
    return _layer2(t_in, params, affines)
