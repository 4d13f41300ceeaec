"""Fused finest-level GRU update: the CUDA kernel ``csrc/gru_update.cu``,
its plain PyTorch version, and the weight pack both take.

Replaces the TPU kernel ``raftstereo_tpu/ops/pallas_gru.py``
``_gru_update_kernel``: motion encoder, gru0 gates, blend and flow head
in one call per iteration, ``(h, ext, corr, disp, cz, cr, cq) -> (h',
delta)``, all NHWC, fp32 or bf16 (``disp`` always fp32).  The bound on an
H100 and what the design does about it are in the source's note: about
128 GFLOP per call at the flagship shapes, bound by operations; the six
big convs run on the tensor cores (bf16 ``mma.sync``, about 0.13 ms at
the dense rate; fp32 as 3xTF32, about 0.77 ms), fed by TMA.  Where hd or
ext_dim is not a multiple of 16 bytes (4 fp32, 8 bf16 channels), the
kernel first copies h and ext into its workspace at the width rounded
up: one launch more.

The bf16 form rounds where the JAX kernel casts to the compute dtype:
each conv is an fp32 sum of exact products of bf16 values plus the
bias, then rounded; the gate arithmetic rounds after every operation;
the disparity enters rounded to bf16; delta comes out in bf16.

The pack (``pack_update_params``) holds the plain version's entries and,
for the kernel, each tensor-core conv's weights as one (N, K) matrix in
the kernel's reduction order (``k*`` keys; ``kernel_operands``), in fp32
as two TF32 planes, hi and lo (``tf32_round``).

``gru_update`` runs the plain version for CPU tensors and the kernel for
CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

# Pointer order of the kernel's weight array (csrc/gru_update.cu).
WEIGHT_ORDER = ("wc1", "bc1", "kc2", "bc2", "wf1", "bf1", "kf2", "bf2",
                "kme", "bme", "kzr", "bzr", "kq", "bq", "kfh1", "bfh1",
                "wfh2", "bfh2")
# The plain version's entries.
PLAIN_KEYS = ("wc1", "bc1", "wc2", "bc2", "wf1", "bf1", "wf2", "bf2",
              "wme_c", "wme_f", "bme",
              "wzr_h", "wzr_m", "wzr_d", "wzr_e", "bzr",
              "wq_h", "wq_m", "wq_d", "wq_e", "bq",
              "wfh1", "bfh1", "wfh2", "bfh2")
_MOTION, _ME, _MF, _HEAD, _DELTA = 64, 126, 128, 256, 2
_ROW_BYTES = 128  # bytes of one pipeline stage of a weight row


def _flat(w: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight -> (kh*kw*cin, cout), the plain version's
    [tap][cin][cout] layout (HWIO flattened)."""
    o, i, kh, kw = w.shape
    return w.detach().permute(2, 3, 1, 0).reshape(kh * kw * i, o).contiguous()


def stage_elems(dtype: torch.dtype) -> int:
    """Channels of one 128-byte pipeline stage: 32 fp32 or 64 bf16."""
    return _ROW_BYTES // dtype.itemsize


def kernel_operands(hd: int, ext_dim: int) -> Dict[str, tuple]:
    """Each tensor-core conv's kernel-layout key -> (outputs N, the input
    channel ranges ``(start, width)`` of its module conv, one per kernel
    operand, in the kernel's order).  The gate convs read [h | mf | ext]:
    mf is the 128-channel motion features [me, disp, 0], whose weights
    are the module's me and disparity channels with the y-flow channel
    (a structural zero) left out, i.e. zero-padded."""
    gate = [(0, hd), (hd, _ME + 1)]
    if ext_dim:
        gate.append((hd + _MF, ext_dim))
    return {"kc2": (_MOTION, [(0, _MOTION)]),
            "kf2": (_MOTION, [(0, _MOTION)]),
            "kme": (_MF, [(0, _MOTION), (_MOTION, _MOTION)]),
            "kzr": (2 * hd, gate), "kq": (hd, gate),
            "kfh1": (_HEAD, [(0, hd)])}


@functools.lru_cache(maxsize=None)
def kernel_shape(key: str, hd: int, ext_dim: int,
                 dtype: torch.dtype) -> Tuple[int, ...]:
    """Shape of a kernel-layout entry: (N, K) in bf16, (2, N, K) in fp32
    (the hi and lo planes), K = 9 taps x each operand's width rounded up
    to a whole stage."""
    n, ranges = kernel_operands(hd, ext_dim)[key]
    e = stage_elems(dtype)
    k = sum(9 * -(-cin // e) * e for _, cin in ranges)
    return (n, k) if dtype == torch.bfloat16 else (2, n, k)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on fp32 values: round to nearest on 10
    mantissa bits (13 bits dropped), ties away from zero, kept as fp32
    with the low 13 bits 0."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _kernel_weight(w: torch.Tensor, n_out: int, ranges,
                   dtype: torch.dtype) -> torch.Tensor:
    """OIHW module weight -> the kernel's (N, K) matrix: for each operand
    range, tap-major (tap = ky*3 + kx), then its channels zero-padded to
    a whole stage; outputs past the module's zero-padded to ``n_out``.
    fp32: the (hi, lo) TF32 planes."""
    w = w.detach().float()
    o, e = w.shape[0], stage_elems(dtype)
    parts = []
    for start, cin in ranges:
        s = w[:, start:start + cin].permute(0, 2, 3, 1).reshape(o, 9, cin)
        parts.append(F.pad(s, (0, -(-cin // e) * e - cin)).reshape(o, -1))
    k = F.pad(torch.cat(parts, 1), (0, 0, 0, n_out - o))
    if dtype == torch.bfloat16:
        return k.to(dtype).contiguous()
    hi = tf32_round(k)
    return torch.stack([hi, tf32_round(k - hi)]).contiguous()


def pack_update_params(update_block, ext_dim: int,
                       dtype: torch.dtype = torch.float32
                       ) -> Dict[str, torch.Tensor]:
    """Weight pack of the finest-level update from the port's
    ``BasicMultiUpdateBlock`` (the counterpart of the JAX package's
    ``pallas_gru.pack_update_params``), every entry in ``dtype`` (the
    compute dtype).  The plain version's entries (``PLAIN_KEYS``): the
    gate convs' kernels sliced along their input as [h | me | disp |
    (y-flow) | ext], the y-flow slice (it multiplies a structural zero)
    dropped, as is convf1's y-flow input; convc1 at the natural
    correlation width.  The kernel's ``k*`` entries: ``_kernel_weight``
    of each tensor-core conv over ``kernel_operands``."""
    enc = update_block.encoder
    gru = update_block.gru08
    fh = update_block.flow_head
    hd = gru.convq.weight.shape[0]
    kzr, kq = gru.convzr.weight, gru.convq.weight
    if kzr.shape[1] != hd + _MF + ext_dim:
        raise ValueError(f"gru08 input width {kzr.shape[1]} != "
                         f"{hd} + 128 + {ext_dim}")
    me0, me1 = hd + _ME, hd + _ME + 1      # [me | disp] inside mf
    kme = enc.conv.weight
    w = {
        "wc1": _flat(enc.convc1.weight), "bc1": enc.convc1.bias,
        "wc2": _flat(enc.convc2.weight), "bc2": enc.convc2.bias,
        "wf1": _flat(enc.convf1.weight[:, :1]), "bf1": enc.convf1.bias,
        "wf2": _flat(enc.convf2.weight), "bf2": enc.convf2.bias,
        "wme_c": _flat(kme[:, :_MOTION]), "wme_f": _flat(kme[:, _MOTION:]),
        "bme": enc.conv.bias,
        "wzr_h": _flat(kzr[:, :hd]), "wzr_m": _flat(kzr[:, hd:me0]),
        "wzr_d": _flat(kzr[:, me0:me1]), "bzr": gru.convzr.bias,
        "wq_h": _flat(kq[:, :hd]), "wq_m": _flat(kq[:, hd:me0]),
        "wq_d": _flat(kq[:, me0:me1]), "bq": gru.convq.bias,
        "wfh1": _flat(fh.conv1.weight), "bfh1": fh.conv1.bias,
        "wfh2": _flat(fh.conv2.weight), "bfh2": fh.conv2.bias,
    }
    if ext_dim:
        w["wzr_e"] = _flat(kzr[:, hd + _MF:])
        w["wq_e"] = _flat(kq[:, hd + _MF:])
    pack = {k: v.detach().float().to(dtype).contiguous()
            for k, v in w.items()}
    module = {"kc2": enc.convc2.weight, "kf2": enc.convf2.weight,
              "kme": kme, "kzr": kzr, "kq": kq, "kfh1": fh.conv1.weight}
    for k, (n, ranges) in kernel_operands(hd, ext_dim).items():
        pack[k] = _kernel_weight(module[k], n, ranges, dtype)
    return pack


def _conv(xs, ws, bias):
    """Sum of SAME convs of NCHW inputs ``xs`` with flat weights ``ws``
    (one conv over the channel concatenation), plus ``bias``."""
    ks = int(round((ws[0].shape[0] // xs[0].shape[1]) ** 0.5))
    k = torch.cat([w.reshape(ks, ks, xi.shape[1], w.shape[-1])
                   for xi, w in zip(xs, ws)], dim=2)      # HWIO
    return F.conv2d(torch.cat(xs, dim=1), k.permute(3, 2, 0, 1), bias,
                    padding=ks // 2)


class _SigmoidBf16(torch.autograd.Function):
    """``jax.nn.sigmoid`` (``lax.logistic``) of a bf16 tensor with JAX's
    differentiation rule: the VJP is ``g * (ans * (1 - ans))``, each
    operation rounded to bf16 (autograd through the forward's ops would
    round elsewhere and differ for about two thirds of inputs)."""

    @staticmethod
    def forward(ctx, x):
        one = torch.ones((), dtype=x.dtype, device=x.device)
        ans = one / (one + torch.exp(-x))
        ctx.save_for_backward(ans)
        return ans

    @staticmethod
    def backward(ctx, g):
        (ans,) = ctx.saved_tensors
        return g * (ans * (1 - ans))


class _TanhBf16(torch.autograd.Function):
    """``jnp.tanh`` of a bf16 tensor with JAX's differentiation rule:
    the VJP is ``u + u * ans`` with ``u = g * (1 - ans)``, each operation
    rounded to bf16 (torch's own rounds ``g * (1 - ans^2)`` once, and
    differs for about two fifths of inputs)."""

    @staticmethod
    def forward(ctx, x):
        ans = torch.tanh(x)
        ctx.save_for_backward(ans)
        return ans

    @staticmethod
    def backward(ctx, g):
        (ans,) = ctx.saved_tensors
        u = g * (1 - ans)
        return u + u * ans


def sigmoid_bf16(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` of a bf16 tensor as XLA computes it:
    ``1 / (1 + exp(-x))`` with every operation rounded to bf16 (not the
    fp32 sigmoid rounded once, which differs for about a third of
    inputs), differentiated by JAX's rule (``_SigmoidBf16``)."""
    return _SigmoidBf16.apply(x)


def tanh_bf16(x: torch.Tensor) -> torch.Tensor:
    """``jnp.tanh`` of a bf16 tensor, differentiated by JAX's rule
    (``_TanhBf16``)."""
    return _TanhBf16.apply(x)


def _gru_update_plain_bf16(h, ext, corr, disp, cz, cr, cq, wpack):
    """The bf16 form: every conv an fp32 conv of the bf16 values plus the
    bias, rounded to bf16 (the JAX kernel's ``_conv3(...).astype(ct)``);
    the gate arithmetic in bf16 tensor ops, each rounded, the sigmoid as
    ``sigmoid_bf16``."""
    bf = torch.bfloat16

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    def conv(xs, names, bias, relu=True):
        y = _conv([t.float() for t in xs], [wpack[k].float() for k in names],
                  wpack[bias].float()).to(bf)
        return F.relu(y) if relu else y

    hh, dd = nchw(h), nchw(disp).to(bf)
    c1 = conv([nchw(corr)], ["wc1"], "bc1")
    cor = conv([c1], ["wc2"], "bc2")
    flo = conv([conv([dd], ["wf1"], "bf1")], ["wf2"], "bf2")
    me = conv([cor, flo], ["wme_c", "wme_f"], "bme")
    xs, wz, wq = [me, dd], ["wzr_m", "wzr_d"], ["wq_m", "wq_d"]
    if ext is not None:
        xs.append(nchw(ext))
        wz.append("wzr_e")
        wq.append("wq_e")
    hd = h.shape[-1]
    zr = conv([hh] + xs, ["wzr_h"] + wz, "bzr", relu=False)
    z = sigmoid_bf16(zr[:, :hd] + nchw(cz))
    r = sigmoid_bf16(zr[:, hd:] + nchw(cr))
    q = torch.tanh(conv([r * hh] + xs, ["wq_h"] + wq, "bq", relu=False)
                   + nchw(cq))
    hn = (1 - z) * hh + z * q
    delta = conv([conv([hn], ["wfh1"], "bfh1")], ["wfh2"], "bfh2", relu=False)
    return (hn.permute(0, 2, 3, 1).contiguous(),
            delta.permute(0, 2, 3, 1).contiguous())


def gru_update_plain(h, ext, corr, disp, cz, cr, cq,
                     wpack) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused update on the same pack: NHWC in,
    ``(h', delta)`` NHWC out (delta has 2 channels), in h's dtype."""
    if h.dtype == torch.bfloat16:
        return _gru_update_plain_bf16(h, ext, corr, disp, cz, cr, cq, wpack)

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    hh, dd = nchw(h), nchw(disp)
    c1 = F.relu(_conv([nchw(corr)], [wpack["wc1"]], wpack["bc1"]))
    cor = F.relu(_conv([c1], [wpack["wc2"]], wpack["bc2"]))
    f1 = F.relu(_conv([dd], [wpack["wf1"]], wpack["bf1"]))
    flo = F.relu(_conv([f1], [wpack["wf2"]], wpack["bf2"]))
    me = F.relu(_conv([cor, flo], [wpack["wme_c"], wpack["wme_f"]],
                      wpack["bme"]))
    xs, wz, wq = [me, dd], [wpack["wzr_m"], wpack["wzr_d"]], \
        [wpack["wq_m"], wpack["wq_d"]]
    if ext is not None:
        xs.append(nchw(ext))
        wz.append(wpack["wzr_e"])
        wq.append(wpack["wq_e"])
    hd = h.shape[-1]
    zr = _conv([hh] + xs, [wpack["wzr_h"]] + wz, wpack["bzr"])
    z = torch.sigmoid(zr[:, :hd] + nchw(cz))
    r = torch.sigmoid(zr[:, hd:] + nchw(cr))
    q = torch.tanh(_conv([r * hh] + xs, [wpack["wq_h"]] + wq, wpack["bq"])
                   + nchw(cq))
    hn = (1 - z) * hh + z * q
    fh = F.relu(_conv([hn], [wpack["wfh1"]], wpack["bfh1"]))
    delta = _conv([fh], [wpack["wfh2"]], wpack["bfh2"])
    return (hn.permute(0, 2, 3, 1).contiguous(),
            delta.permute(0, 2, 3, 1).contiguous())


def gru_update(h: torch.Tensor, ext: Optional[torch.Tensor],
               corr: torch.Tensor, disp: torch.Tensor, cz: torch.Tensor,
               cr: torch.Tensor, cq: torch.Tensor,
               wpack: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused update: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (counted in ``gru_update.launches``).  h/cz/cr/cq
    (B, H, W, hd), ext (B, H, W, e) or None, corr (B, H, W, Ck), disp
    (B, H, W, 1)."""
    acts = [t for t in (h, ext, corr, disp, cz, cr, cq) if t is not None]
    weights = list(wpack.values())
    if all(t.device.type == "cpu" for t in acts + weights):
        return gru_update_plain(h, ext, corr, disp, cz, cr, cq, wpack)
    dev = h.device
    if dev.type != "cuda" or any(t.device != dev for t in acts + weights):
        raise ValueError("gru_update: all tensors must be on one CUDA device")
    b, hh, ww, hd = h.shape
    ext_dim = 0 if ext is None else ext.shape[-1]
    want = {"cz": (cz, hd), "cr": (cr, hd), "cq": (cq, hd), "disp": (disp, 1),
            "corr": (corr, corr.shape[-1])}
    if ext is not None:
        want["ext"] = (ext, ext_dim)
    for name, (t, ch) in want.items():
        if t.shape != (b, hh, ww, ch):
            raise ValueError(f"{name} {tuple(t.shape)} != {(b, hh, ww, ch)}")
    dt = h.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gru_update runs float32 or bfloat16, not {dt}")
    for t in acts + weights:
        want_dt = torch.float32 if t is disp else dt
        if t.dtype != want_dt or not t.is_contiguous():
            raise ValueError(f"gru_update takes contiguous {dt} tensors "
                             f"(disp float32); got {t.dtype}")
    ck, mo = corr.shape[-1], _MOTION
    shapes = {"wc1": (ck, mo), "bc1": (mo,), "bc2": (mo,), "wf1": (49, mo),
              "bf1": (mo,), "bf2": (mo,), "bme": (_ME,), "bzr": (2 * hd,),
              "bq": (hd,), "bfh1": (_HEAD,), "wfh2": (9 * _HEAD, _DELTA),
              "bfh2": (_DELTA,)}
    shapes.update({k: kernel_shape(k, hd, ext_dim, dt)
                   for k in ("kc2", "kf2", "kme", "kzr", "kq", "kfh1")})
    for k, s in shapes.items():
        if k not in wpack or tuple(wpack[k].shape) != s:
            raise ValueError(f"weight pack {k}: "
                             f"{tuple(wpack[k].shape) if k in wpack else None}"
                             f" != {s}")
    hn = torch.empty_like(h)
    delta = torch.empty((b, hh, ww, _DELTA), dtype=dt, device=dev)
    ptrs = (ctypes.c_void_p * len(WEIGHT_ORDER))(
        *[wpack[k].data_ptr() for k in WEIGHT_ORDER])
    lib = _build.load("gru_update")
    size = lib.gru_update_workspace_elems
    size.restype = ctypes.c_long
    size.argtypes = [ctypes.c_int] * 6
    # The bf16 form keeps its intermediates in bf16.
    ws = torch.empty(size(b, hh, ww, hd, ext_dim, h.element_size()),
                     dtype=dt, device=dev)
    fn = (lib.gru_update_forward if dt == torch.float32
          else lib.gru_update_forward_bf16)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(h.data_ptr(), ext.data_ptr() if ext is not None else None,
                corr.data_ptr(), disp.data_ptr(), cz.data_ptr(),
                cr.data_ptr(), cq.data_ptr(), ptrs, hn.data_ptr(),
                delta.data_ptr(), ws.data_ptr(), b, hh, ww, hd, ext_dim, ck,
                stream)
    if rc != 0:
        raise RuntimeError(
            f"gru_update kernel launch failed: " + (
                f"CUDA error {rc}" if rc < 9999 else
                "no cuTensorMapEncodeTiled in the driver" if rc == 9999 else
                f"tensor map refused, CUresult {rc - 10000}"))
    gru_update.launches += 1
    return hn, delta


gru_update.launches = 0
