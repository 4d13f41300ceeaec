"""The fused encoder stages' kernels: ``csrc/enc_conv_tc.cu`` (the 3x3
convs of layer1 and layer2 on the tensor cores, 3xTF32: prep ->
convolution -> + bias), ``csrc/enc_conv.cu`` (the 7x7 stems, both strides
one tensor-core kernel, 3xTF32), both with per-(image, channel) output
sums, ``csrc/enc_stats.cu``
(the plane sums of a tensor, and the two sums of the instance-norm
backward) and ``csrc/enc_finish.cu`` (the stages' last elementwise pass),
their plain PyTorch versions, and one wrapper per TPU kernel they
replace, each with its own ``launches`` count:

=====================  ==================================================
wrapper                TPU kernel (``raftstereo_tpu/ops/...``)
=====================  ==================================================
``stem_conv7``         row 13, ``pallas_encoder.py`` ``_stem7_kernel``
                       (``enc_conv.cu``, tensor cores)
``stem_conv7_s2``      row 12, ``pallas_encoder.py`` ``_stem7s2_kernel``
                       (``enc_conv.cu``, tensor cores)
``stage_conv``         row 9, ``pallas_encoder.py`` ``_enc_conv_kernel``,
                       ``_enc_conv_res_kernel`` (``enc_conv_tc.cu``)
``plane_stats``        row 10, ``pallas_norm.py`` ``_in_stats_kernel`` as
                       ``pallas_encoder.py`` ``_packed_stats`` reaches it
``stage_finish``       row 11, ``pallas_encoder.py`` ``_enc_finish_kernel``
``dual_sums``          row 14, ``pallas_encoder.py`` ``_dual_sum_kernel``
``l2_entry``           row 15, ``pallas_layer2.py`` ``_l2_entry_kernel``
                       (``enc_conv_tc.cu``; bf16 ``enc_conv_wg.cu``)
``l2_conv``            row 16, ``pallas_layer2.py`` ``_l2_conv_kernel``,
                       ``_l2_conv_res_kernel`` (``enc_conv_tc.cu``; bf16
                       ``enc_conv_wg.cu``)
``l2_finish``          row 17, ``pallas_layer2.py`` ``_l2_finish_kernel``
=====================  ==================================================

Tensors are NCHW, as in the port's encoders.  A prep affine ``aff`` is a
pair ``(s, t)`` of (B, C) tensors and preps ``x`` as relu(x*s + t); a
stage's output sums are ``(sum, sum of squares)``, each (B, C), of the
fp32 raw output including the bias.  Convolution zero padding applies
AFTER the prep, as on the TPU.  The bounds on an H100 and what each
kernel's design does about them are in the sources' notes: the
convolutions are bound by operations, the stats and finish by bytes.

Each wrapper runs the plain version for CPU tensors and its kernel for
CUDA tensors (counted in ``<wrapper>.launches``); it never falls back from
one to the other.  The convolution wrappers repack the OIHW weights on
every call (``tc_pack`` for the tensor-core kernel: 295 KB at 64->64), so
nothing goes stale after ``load_state_dict``.

Every wrapper takes float32 or bfloat16 activations and dispatches on
their dtype: float32 to the fp32 kernels, bfloat16 to their bf16 forms
(the JAX kernels at ``dt=bfloat16``: the fast and turbo tiers of a fused
base, and ``dual_sums`` in the stages' bf16 backward); the bf16 forms of
``l2_entry`` and ``l2_conv`` are ``enc_conv_wg.cu``'s persistent
``wgmma`` conv (weights as ``wg_pack``), which takes 3x3 convs to 96
outputs only.  Affines and sums
stay float32; any other dtype or mix raises.  The bf16 forms round where
the JAX kernels round: the prep casts the fp32 affine to bf16 and rounds
after each product and each sum (never one fused multiply-add); a
convolution takes bf16 operands (the weights and bias cast at use), sums
its exact products in fp32, adds the bias in fp32, takes the output sums
of that fp32 result and rounds it to bf16 once.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .cuda_gru import tf32_round

Affine = Tuple[torch.Tensor, torch.Tensor]
BF16 = torch.bfloat16

# enc_conv.cu's output tile (kTileH, kTileW: 8x32 pixels, all 64
# outputs) and weight shape (3 -> 64 channels, 7x7); the tensor-core 3x3
# convs take Cout in multiples of 32 (enc_conv_tc.cu's entry checks it).
_TILE_H, _TILE_W, _COUT_TILE = 8, 32, 32
STEM_WEIGHT = (64, 3, 7, 7)
STEMS = {"stem_conv7": 1, "stem_conv7_s2": 2}  # wrapper -> stride
_NONE, _PREP, _RES, _RES_PROJ = 0, 1, 2, 3
# enc_conv_tc.cu's geometry: output rows per block (kTH), input channels
# per stage (kKC), and its instances (kInst) by wrapper: (instance id,
# stride, output columns per block 8*MT, outputs per block 16*NT).
TC_TILE_H, TC_STAGE = 8, 8
TC_STAGE_BF16 = 16  # enc_conv_tc.cu's kKCB: one k16 step a tap
TC_INSTANCES = {"stage_conv": (0, 1, 32, 64), "l2_entry": (1, 2, 16, 96),
                "l2_conv": (2, 1, 16, 96)}


def stem_geometry(h: int, w: int, stride: int):
    """The stems' output (ho, wo) for an (h, w) image at ``stride`` (7x7,
    zero padding 3) and their 8x32 output tiles per image ``nb``."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    return ho, wo, -(-ho // _TILE_H) * -(-wo // _TILE_W)


def tc_geometry(h: int, w: int, instance: str):
    """The tensor-core conv's launch geometry for an (h, w) input to the
    instance of wrapper ``instance``: the output (ho, wo), output columns
    per block, outputs per block, and blocks per image ``nb`` (8-row
    tiles; the last tile of each axis overhangs the output and its pixels
    there are never stored)."""
    _, stride, tw, bn = TC_INSTANCES[instance]
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    return ho, wo, tw, bn, -(-ho // TC_TILE_H) * -(-wo // tw)


def tc_pack(weight: torch.Tensor, proj_weight: Optional[torch.Tensor],
            bn: int) -> torch.Tensor:
    """The tensor-core conv's weights, each stage's tap blocks as they
    lie in shared memory: (Cout tiles of ``bn``, stages of 8 input
    channels, taps (9, ky*3 + kx; a tenth for the 1x1 ``proj_weight``), 2
    (TF32 hi = ``tf32_round(w)``, lo = ``tf32_round(w - hi)``), bn
    outputs, 8 channels), fp32, zero past Cout and Cin.  In rows whose
    output index has bit 2 set the two 4-channel halves are swapped (the
    kernel's bank-conflict-free layout)."""
    o, i = weight.shape[:2]
    w = weight.detach().float().permute(0, 2, 3, 1).reshape(o, 9, i)
    if proj_weight is not None:
        w = torch.cat([w, proj_weight.detach().float().reshape(o, 1, i)], 1)
    nt, nk = -(-o // bn), -(-i // TC_STAGE)
    w = F.pad(w, (0, nk * TC_STAGE - i, 0, 0, 0, nt * bn - o))
    w = w.reshape(nt, bn, w.shape[1], nk, TC_STAGE).permute(0, 3, 2, 1, 4)
    swap = ((torch.arange(bn, device=w.device) >> 2) & 1).bool()
    w = torch.where(swap[:, None], w.roll(TC_STAGE // 2, -1), w)
    hi = tf32_round(w)
    return torch.stack([hi, tf32_round(w - hi)], 3).contiguous()


def tc_pack_bf16(weight: torch.Tensor, bn: int) -> torch.Tensor:
    """Row 9's bf16 tensor-core conv's weights, each stage's tap blocks as
    they lie in shared memory: (Cout tiles of ``bn``, stages of 16 input
    channels, 9 taps (ky*3 + kx), bn outputs, 16 channels), bf16
    (``weight`` rounded once), zero past Cout and Cin.  In rows whose
    output index has bit 2 set the two 8-channel halves are swapped, as
    ``tc_pack`` swaps its 4-channel halves: a row is 32 bytes in both."""
    o, i = weight.shape[:2]
    w = weight.detach().to(BF16).permute(0, 2, 3, 1).reshape(o, 9, i)
    nt, nk = -(-o // bn), -(-i // TC_STAGE_BF16)
    w = F.pad(w, (0, nk * TC_STAGE_BF16 - i, 0, 0, 0, nt * bn - o))
    w = w.reshape(nt, bn, w.shape[1], nk, TC_STAGE_BF16).permute(0, 3, 2, 1,
                                                                  4)
    swap = ((torch.arange(bn, device=w.device) >> 2) & 1).bool()
    w = torch.where(swap[:, None], w.roll(TC_STAGE_BF16 // 2, -1), w)
    return w.contiguous()


# enc_conv_wg.cu's geometry (the bf16 forms of rows 15 and 16): input
# channels a k-step (kKC), outputs (kN: all of Cout in one wgmma N),
# output columns a tile (kTW), and by wrapper (stride, output rows a tile,
# largest Cin).
WG_STAGE, WG_COUT, WG_TILE_W = 16, 96, 64
WG_INSTANCES = {"l2_entry": (2, 2, 64), "l2_conv": (1, 4, 96)}


def wg_geometry(h: int, w: int, instance: str):
    """The wgmma conv's output (ho, wo) for an (h, w) input to wrapper
    ``instance``'s bf16 form and its tiles per image ``nb`` (TH x 64
    pixels; the last tile of each axis overhangs the output)."""
    stride, th, _ = WG_INSTANCES[instance]
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    return ho, wo, -(-ho // th) * -(-wo // WG_TILE_W)


def wg_pack(weight: torch.Tensor,
            proj_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The wgmma conv's weights, laid out as its B descriptors read them:
    (k-steps of 16 input channels, taps (9, ky*3 + kx; a tenth for the 1x1
    ``proj_weight``), 2 (channels 0-7 | 8-15 of the k-step), Cout, 8)
    bf16 (``weight`` rounded once), zero past Cin.  A (k-step, tap) block
    is 2 x Cout rows of 16 bytes: core matrices of 8 outputs 128 bytes
    apart (SBO), the two channel halves Cout * 16 bytes apart (LBO)."""
    o, i = weight.shape[:2]
    w = weight.detach().to(BF16).permute(0, 2, 3, 1).reshape(o, 9, i)
    if proj_weight is not None:
        w = torch.cat([w, proj_weight.detach().to(BF16).reshape(o, 1, i)],
                      1)
    nk = -(-i // WG_STAGE)
    w = F.pad(w, (0, nk * WG_STAGE - i))
    return w.reshape(o, w.shape[1], nk, 2, 8).permute(2, 1, 3, 0,
                                                      4).contiguous()


# ------------------------------------------------------- plain versions

def prep(x: torch.Tensor, aff: Affine, relu: bool = True) -> torch.Tensor:
    """relu(x*s + t) per (image, channel); no relu with ``relu=False``.
    The affine is cast to ``x``'s dtype first, as the JAX kernels' prep
    casts it: in bf16 the product and the sum each round to bf16."""
    s, t = (a.to(x.dtype)[:, :, None, None] for a in aff)
    y = x * s + t
    return torch.relu(y) if relu else y


def stats_plain(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (sum, sum of squares) over (H, W), each (B, C); a bf16 ``y``
    is summed in fp32."""
    y = y.float()
    return y.sum(dim=(2, 3)), (y * y).sum(dim=(2, 3))


def dual_sums_plain(u: torch.Tensor, v: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (sum of u, sum of u*v) over (H, W), each (B, C).  bf16
    operands are upcast before they are multiplied and summed, as the TPU
    kernel upcasts them in registers: each product of two bf16 values is
    exact in fp32."""
    u, v = u.float(), v.float()
    return u.sum(dim=(2, 3)), (u * v).sum(dim=(2, 3))


def conv_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               stride: int = 1, aff: Optional[Affine] = None,
               res: Optional[torch.Tensor] = None,
               res_aff: Optional[Affine] = None, res_relu: bool = True,
               want_stats: bool = True):
    """Plain version of ``enc_conv``: the prepped input (``x`` itself
    without ``aff``; with ``res``, relu(prep(res) + prep(x)), the residual
    term without its relu when ``res_relu`` is False), zero-padded, through
    ``F.conv2d``.  A bf16 ``x`` convolves in fp32 over bf16 operands (the
    weights and bias rounded once), so that the sums are of the fp32
    output before it is rounded to bf16, as the JAX kernels take them (a
    bf16 ``F.conv2d`` would round first).  Returns ``(y, sums or
    None)``."""
    t = x if aff is None else prep(x, aff)
    if res is not None:
        t = torch.relu(prep(res, res_aff, relu=res_relu) + t)
    pad = weight.shape[-1] // 2
    if x.dtype != BF16:
        y = F.conv2d(t, weight, bias, stride, pad)
        return y, (stats_plain(y) if want_stats else None)
    y = F.conv2d(t.float(), weight.to(BF16).float(), None, stride, pad)
    if bias is not None:
        y = y + bias.to(BF16).float()[:, None, None]
    return y.to(BF16), (stats_plain(y) if want_stats else None)


def entry_plain(t: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                proj_weight: torch.Tensor, proj_bias: torch.Tensor,
                want_stats: bool = True):
    """Plain version of layer2's entry: the stride-2 3x3 conv and the
    stride-2 1x1 projection of the same input.  Returns ``(c1, p,
    c1 sums, p sums)``."""
    c1, s1 = conv_plain(t, weight, bias, 2, want_stats=want_stats)
    p, sp = conv_plain(t, proj_weight, proj_bias, 2, want_stats=want_stats)
    return c1, p, s1, sp


def finish_plain(a: torch.Tensor, aff_a: Affine, b: torch.Tensor,
                 aff_b: Affine, c: torch.Tensor, aff_c: Affine,
                 a_relu: bool = True) -> torch.Tensor:
    """relu(relu(prep(a) + prep(b)) + prep(c)); ``a``'s prep without its
    relu when ``a_relu`` is False (layer2's projection norm)."""
    return torch.relu(torch.relu(prep(a, aff_a, relu=a_relu)
                                 + prep(b, aff_b)) + prep(c, aff_c))


# ------------------------------------------------------------- kernels

def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts if t is not None)


def _act_dtype(name: str, x: torch.Tensor) -> torch.dtype:
    """The dtype of ``name``'s activations: float32 or bfloat16."""
    if x.dtype not in (torch.float32, BF16):
        raise ValueError(f"{name}: {x.dtype} activations; its kernels take "
                         f"float32 or bfloat16")
    return x.dtype


def _check(name: str, dtype: torch.dtype, acts, f32s=()) -> torch.device:
    """The activations (with the packed weights and biases) contiguous
    ``dtype``, the affines and sums contiguous float32, all on one CUDA
    device."""
    ts = [t for t in (*acts, *f32s) if t is not None]
    dev = ts[0].device
    for t in ts:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: operands on {[u.device for u in ts]};"
                             f" all must be on one CUDA device")
    for group, want in ((acts, dtype), (f32s, torch.float32)):
        for t in group:
            if t is not None and (t.dtype != want or not t.is_contiguous()):
                raise ValueError(
                    f"{name} takes contiguous {dtype} activations and "
                    f"float32 affines; got a {t.dtype} operand "
                    f"(contiguous: {t.is_contiguous()})")
    return dev


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _conv_cuda(name, x, weight, bias, stride, mode=_NONE, aff=None, res=None,
               res_aff=None, proj=None, want_stats=True):
    """One launch of wrapper ``name``'s kernel: ``enc_conv_wg_forward``
    for rows 15 and 16 in bf16 (``WG_INSTANCES``, weights as ``wg_pack``),
    else ``enc_conv_tc_forward`` for the tensor-core instances
    (``TC_INSTANCES``: the 3x3 convs of rows 9, 15 and 16, weights as
    ``tc_pack`` or in bf16 ``tc_pack_bf16``), else ``enc_stem7_tc_forward``
    for the stems (``STEMS``: rows 13 and 12 on the tensor cores, the raw
    image, OIHW weights split in the kernel); ``proj`` the projection's
    (weight, bias).  Returns (y, yp or None, stats (B, 2, CH) or None)."""
    cout, cin, ks, _ = weight.shape
    b, c, h, wd = x.shape
    if c != cin or cout % _COUT_TILE:
        raise ValueError(f"{name}: input channels {c} vs weight {cin}, or "
                         f"Cout {cout} not a multiple of {_COUT_TILE}")
    s, t = aff if aff is not None else (None, None)
    rs, rt = res_aff if res_aff is not None else (None, None)
    for a in (s, t, rs, rt):
        if a is not None and a.shape != (b, c):
            raise ValueError(f"{name}: affine {tuple(a.shape)} != {(b, c)}")
    if res is not None and res.shape != x.shape:
        raise ValueError(f"{name}: residual {tuple(res.shape)} != "
                         f"{tuple(x.shape)}")
    dt = _act_dtype(name, x)
    bf = dt == BF16
    bias = bias.detach().to(dt).contiguous()
    bp = None if proj is None else proj[1].detach().to(dt).contiguous()
    wg = bf and name in WG_INSTANCES
    tc = name in TC_INSTANCES and not wg
    if wg:
        wg_stride, _, max_cin = WG_INSTANCES[name]
        if ks != 3 or stride != wg_stride or cout != WG_COUT or cin > max_cin:
            raise ValueError(f"{name}: a {ks}x{ks} stride-{stride} {cin}->"
                             f"{cout} conv; its bf16 kernel takes 3x3 stride "
                             f"{wg_stride}, Cin <= {max_cin}, Cout "
                             f"{WG_COUT}")
        ho, wo, nb = wg_geometry(h, wd, name)
        w = wg_pack(weight, None if proj is None else proj[0])
    elif tc:
        inst, inst_stride = TC_INSTANCES[name][:2]
        if ks != 3 or stride != inst_stride:
            raise ValueError(f"{name}: a {ks}x{ks} stride-{stride} kernel; "
                             f"this conv is 3x3 stride {inst_stride}")
        ho, wo, _, bn, nb = tc_geometry(h, wd, name)
        w = (tc_pack_bf16(weight, bn) if bf else
             tc_pack(weight, None if proj is None else proj[0], bn))
    else:
        if tuple(weight.shape) != STEM_WEIGHT or stride != STEMS[name]:
            raise ValueError(f"{name}: weight {tuple(weight.shape)}, stride "
                             f"{stride}; the stem takes {STEM_WEIGHT} at "
                             f"stride {STEMS[name]}")
        ho, wo, nb = stem_geometry(h, wd, stride)
        w = weight.detach().to(dt).contiguous()
    dev = _check(name, dt, (x, res, w, bias, bp), (s, t, rs, rt))
    y = torch.empty((b, cout, ho, wo), dtype=dt, device=dev)
    yp = torch.empty_like(y) if proj is not None else None
    ch = cout * (2 if proj is not None else 1)
    partials = stats = None
    if want_stats:
        partials = torch.empty((b, nb, 2, ch), dtype=torch.float32,
                               device=dev)
        stats = torch.empty((b, 2, ch), dtype=torch.float32, device=dev)
    if wg:
        fn = _build.load("enc_conv_wg").enc_conv_wg_forward
        ptrs = [_ptr(x), _ptr(s), _ptr(t), _ptr(res), _ptr(rs), _ptr(rt),
                _ptr(w), _ptr(bias), _ptr(bp), _ptr(y), _ptr(yp)]
        ints = [b, cin, h, wd, cout, stride, mode, nb]
    elif tc:
        fn = _build.load("enc_conv_tc").enc_conv_tc_forward
        ptrs = [_ptr(x), _ptr(s), _ptr(t), _ptr(res), _ptr(rs), _ptr(rt),
                _ptr(w), _ptr(bias), _ptr(bp), _ptr(y), _ptr(yp)]
        ints = [b, cin, h, wd, cout, inst, mode, nb, bn, int(bf)]
    else:
        fn = _build.load("enc_conv").enc_stem7_tc_forward
        ptrs = [_ptr(x), _ptr(w), _ptr(bias), _ptr(y)]
        ints = [b, h, wd, stride, nb, int(bf)]
    ptrs += [_ptr(partials), _ptr(stats)]
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(ints)
                   + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*ptrs, *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return y, yp, stats


def _sums(stats: Optional[torch.Tensor], lo: int, hi: int):
    if stats is None:
        return None
    return stats[:, 0, lo:hi], stats[:, 1, lo:hi]


def stem_conv7(img: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               want_stats: bool = True):
    """7x7 stride-1 conv1 of the (B, 3, H, W) image, zero padding on the
    raw image: ``(y, sums or None)`` (row 13)."""
    if _on_cpu(img, weight, bias):
        return conv_plain(img, weight, bias, 1, want_stats=want_stats)
    y, _, st = _conv_cuda("stem_conv7", img, weight, bias, 1,
                          want_stats=want_stats)
    stem_conv7.launches += 1
    return y, _sums(st, 0, y.shape[1])


def stem_conv7_s2(img: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor, want_stats: bool = True):
    """7x7 stride-2 conv1: output (i, j) reads image rows and columns
    2i-3 .. 2i+3, zero padding on the raw image; ``(y, sums or None)`` (row
    12)."""
    if _on_cpu(img, weight, bias):
        return conv_plain(img, weight, bias, 2, want_stats=want_stats)
    y, _, st = _conv_cuda("stem_conv7_s2", img, weight, bias, 2,
                          want_stats=want_stats)
    stem_conv7_s2.launches += 1
    return y, _sums(st, 0, y.shape[1])


def stage_conv(x: torch.Tensor, aff: Affine, weight: torch.Tensor,
               bias: torch.Tensor, res: Optional[torch.Tensor] = None,
               res_aff: Optional[Affine] = None, want_stats: bool = True):
    """prep -> 3x3 conv of the stem + layer1 stage; with ``res`` the input
    is relu(prep(res) + prep(x)) (the residual block boundary).  ``(y,
    sums or None)`` (row 9)."""
    if _on_cpu(x, res, weight, *aff):
        return conv_plain(x, weight, bias, 1, aff, res, res_aff,
                          want_stats=want_stats)
    y, _, st = _conv_cuda("stage_conv", x, weight, bias, 1,
                          _PREP if res is None else _RES, aff, res, res_aff,
                          want_stats=want_stats)
    stage_conv.launches += 1
    return y, _sums(st, 0, y.shape[1])


def l2_conv(x: torch.Tensor, aff: Affine, weight: torch.Tensor,
            bias: torch.Tensor, res: Optional[torch.Tensor] = None,
            res_aff: Optional[Affine] = None, want_stats: bool = True):
    """prep -> 3x3 conv of layer2; with ``res`` (the projection) the input
    is relu((res*rs + rt) + prep(x)): no relu on the projection term.
    ``(y, sums or None)`` (row 16)."""
    if _on_cpu(x, res, weight, *aff):
        return conv_plain(x, weight, bias, 1, aff, res, res_aff,
                          res_relu=False, want_stats=want_stats)
    y, _, st = _conv_cuda("l2_conv", x, weight, bias, 1,
                          _PREP if res is None else _RES_PROJ, aff, res,
                          res_aff, want_stats=want_stats)
    l2_conv.launches += 1
    return y, _sums(st, 0, y.shape[1])


def l2_entry(t: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             proj_weight: torch.Tensor, proj_bias: torch.Tensor,
             want_stats: bool = True):
    """layer2's entry in one launch: the stride-2 3x3 conv (output (i, j)
    reads 2i-1 .. 2i+1) and the stride-2 1x1 projection (reads (2i, 2j))
    of the post-relu input.  ``(c1, p, c1 sums, p sums)`` (row 15)."""
    if _on_cpu(t, weight, proj_weight):
        return entry_plain(t, weight, bias, proj_weight, proj_bias,
                           want_stats)
    if proj_weight.shape != weight.shape[:2] + (1, 1):
        raise ValueError(f"l2_entry: projection {tuple(proj_weight.shape)}"
                         f" is not 1x1 of {tuple(weight.shape[:2])}")
    y, yp, st = _conv_cuda("l2_entry", t, weight, bias, 2,
                           proj=(proj_weight, proj_bias),
                           want_stats=want_stats)
    l2_entry.launches += 1
    c = y.shape[1]
    return y, yp, _sums(st, 0, c), _sums(st, c, 2 * c)


def plane_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (sum, sum of squares) of each (image, channel) plane (row
    10)."""
    if _on_cpu(x):
        return stats_plain(x)
    dt = _act_dtype("plane_stats", x)
    dev = _check("plane_stats", dt, (x,))
    b, c, h, w = x.shape
    stats = torch.empty((b, 2, c), dtype=torch.float32, device=dev)
    fn = _build.load("enc_stats").enc_stats_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_long, ctypes.c_int,
                   ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), stats.data_ptr(), b, c, h * w,
                int(dt == BF16), stream)
    if rc != 0:
        raise RuntimeError(f"plane_stats kernel launch failed: CUDA error "
                           f"{rc}")
    plane_stats.launches += 1
    return stats[:, 0], stats[:, 1]


def dual_sums(u: torch.Tensor, v: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (sum of u, sum of u*v) of each (image, channel) plane of two
    tensors of one shape: the instance-norm backward's two reductions
    (row 14).  Both float32 or both bfloat16 (the bf16 form: fp32 sums of
    the upcast values)."""
    if _on_cpu(u, v):
        return dual_sums_plain(u, v)
    dt = _act_dtype("dual_sums", u)
    dev = _check("dual_sums", dt, (u, v))
    if u.shape != v.shape or u.dim() != 4:
        raise ValueError(f"dual_sums: shapes {tuple(u.shape)} and "
                         f"{tuple(v.shape)}; want one (B, C, H, W) shape")
    b, c, h, w = u.shape
    sums = torch.empty((b, 2, c), dtype=torch.float32, device=dev)
    fn = _build.load("enc_stats").enc_dual_sums_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_long, ctypes.c_int,
                                           ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(u.data_ptr(), v.data_ptr(), sums.data_ptr(), b, c, h * w,
                int(dt == BF16), stream)
    if rc != 0:
        raise RuntimeError(f"dual_sums kernel launch failed: CUDA error "
                           f"{rc}")
    dual_sums.launches += 1
    return sums[:, 0], sums[:, 1]


def _finish_cuda(name, a, aff_a, b, aff_b, c, aff_c, a_relu):
    dt = _act_dtype(name, a)
    dev = _check(name, dt, (a, b, c), (*aff_a, *aff_b, *aff_c))
    if not a.shape == b.shape == c.shape:
        raise ValueError(f"{name}: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)} differ")
    n, ch, h, w = a.shape
    for t in (*aff_a, *aff_b, *aff_c):
        if t.shape != (n, ch):
            raise ValueError(f"{name}: affine {tuple(t.shape)} != {(n, ch)}")
    out = torch.empty_like(a)
    fn = _build.load("enc_finish").enc_finish_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_long, ctypes.c_long,
                                            ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(a.data_ptr(), aff_a[0].data_ptr(), aff_a[1].data_ptr(),
                b.data_ptr(), aff_b[0].data_ptr(), aff_b[1].data_ptr(),
                c.data_ptr(), aff_c[0].data_ptr(), aff_c[1].data_ptr(),
                out.data_ptr(), n * ch, h * w, int(a_relu), int(dt == BF16),
                stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out


def stage_finish(y1: torch.Tensor, aff1: Affine, c11: torch.Tensor,
                 aff11: Affine, c21: torch.Tensor,
                 aff21: Affine) -> torch.Tensor:
    """The stem + layer1 stage's output relu(relu(t0 + u2) + v2), t0, u2,
    v2 the prepped y1, c11, c21 (row 11)."""
    if _on_cpu(y1, c11, c21):
        return finish_plain(y1, aff1, c11, aff11, c21, aff21)
    out = _finish_cuda("stage_finish", y1, aff1, c11, aff11, c21, aff21,
                       True)
    stage_finish.launches += 1
    return out


def l2_finish(p: torch.Tensor, aff_p: Affine, c2: torch.Tensor,
              aff2: Affine, c4: torch.Tensor, aff4: Affine) -> torch.Tensor:
    """layer2's output relu(relu(pn + u2) + y4), pn = p*sp + tp without
    relu, u2 and y4 the prepped c2 and c4 (row 17)."""
    if _on_cpu(p, c2, c4):
        return finish_plain(p, aff_p, c2, aff2, c4, aff4, a_relu=False)
    out = _finish_cuda("l2_finish", p, aff_p, c2, aff2, c4, aff4, False)
    l2_finish.launches += 1
    return out


WRAPPERS = (stem_conv7, stem_conv7_s2, stage_conv, plane_stats,
            stage_finish, l2_entry, l2_conv, l2_finish, dual_sums)
for _fn in WRAPPERS:
    _fn.launches = 0
