"""Fused finest-level GRU update: the CUDA kernel ``csrc/gru_update.cu``,
its plain PyTorch version, and the weight pack both take.

Replaces the TPU kernel ``raftstereo_tpu/ops/pallas_gru.py``
``_gru_update_kernel``: motion encoder, gru0 gates, blend and flow head
in one call per iteration, ``(h, ext, corr, disp, cz, cr, cq) -> (h',
delta)``, all NHWC fp32.  The bound on an H100 and what the design does
about it are in the source's note: about 128 GFLOP per call at the
flagship shapes, bound by fp32 operations (about 2 ms at 67 TFLOP/s).

``gru_update`` runs the plain version for CPU tensors and the kernel for
CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

# Pointer order of the kernel's weight array (csrc/gru_update.cu).
WEIGHT_ORDER = ("wc1", "bc1", "wc2", "bc2", "wf1", "bf1", "wf2", "bf2",
                "wme_c", "wme_f", "bme",
                "wzr_h", "wzr_m", "wzr_d", "wzr_e", "bzr",
                "wq_h", "wq_m", "wq_d", "wq_e", "bq",
                "wfh1", "bfh1", "wfh2", "bfh2")
_MOTION, _ME, _HEAD, _DELTA = 64, 126, 256, 2


def _flat(w: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight -> (kh*kw*cin, cout), the kernel's [tap][cin][cout]
    layout (HWIO flattened)."""
    o, i, kh, kw = w.shape
    return w.detach().permute(2, 3, 1, 0).reshape(kh * kw * i, o).contiguous()


def pack_update_params(update_block, ext_dim: int) -> Dict[str, torch.Tensor]:
    """Weight pack of the finest-level update from the port's
    ``BasicMultiUpdateBlock`` (the counterpart of the JAX package's
    ``pallas_gru.pack_update_params``).  The gate convs' kernels are sliced
    along their input as [h | me | disp | (y-flow) | ext]; the y-flow
    slice multiplies a structural zero and is dropped, as is convf1's
    y-flow input.  convc1 stays at the natural correlation width."""
    enc = update_block.encoder
    gru = update_block.gru08
    fh = update_block.flow_head
    hd = gru.convq.weight.shape[0]
    kzr, kq = gru.convzr.weight, gru.convq.weight
    if kzr.shape[1] != hd + 128 + ext_dim:
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
        w["wzr_e"] = _flat(kzr[:, hd + 128:])
        w["wq_e"] = _flat(kq[:, hd + 128:])
    return {k: v.detach().float().contiguous() for k, v in w.items()}


def _conv(xs, ws, bias):
    """Sum of SAME convs of NCHW inputs ``xs`` with flat weights ``ws``
    (one conv over the channel concatenation), plus ``bias``."""
    ks = int(round((ws[0].shape[0] // xs[0].shape[1]) ** 0.5))
    k = torch.cat([w.reshape(ks, ks, xi.shape[1], w.shape[-1])
                   for xi, w in zip(xs, ws)], dim=2)      # HWIO
    return F.conv2d(torch.cat(xs, dim=1), k.permute(3, 2, 0, 1), bias,
                    padding=ks // 2)


def gru_update_plain(h, ext, corr, disp, cz, cr, cq,
                     wpack) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused update on the same pack: NHWC in,
    ``(h', delta)`` NHWC out (delta has 2 channels)."""
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
    for t in acts + weights:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("gru_update takes contiguous float32 tensors")
    ck, mo = corr.shape[-1], _MOTION
    shapes = {"wc1": (ck, mo), "bc1": (mo,), "wc2": (9 * mo, mo),
              "bc2": (mo,), "wf1": (49, mo), "bf1": (mo,),
              "wf2": (9 * mo, mo), "bf2": (mo,), "wme_c": (9 * mo, _ME),
              "wme_f": (9 * mo, _ME), "bme": (_ME,),
              "wzr_h": (9 * hd, 2 * hd), "wzr_m": (9 * _ME, 2 * hd),
              "wzr_d": (9, 2 * hd), "bzr": (2 * hd,), "wq_h": (9 * hd, hd),
              "wq_m": (9 * _ME, hd), "wq_d": (9, hd), "bq": (hd,),
              "wfh1": (9 * hd, _HEAD), "bfh1": (_HEAD,),
              "wfh2": (9 * _HEAD, _DELTA), "bfh2": (_DELTA,)}
    if ext is not None:
        shapes.update(wzr_e=(9 * ext_dim, 2 * hd), wq_e=(9 * ext_dim, hd))
    for k, s in shapes.items():
        if k not in wpack or tuple(wpack[k].shape) != s:
            raise ValueError(f"weight pack {k}: "
                             f"{tuple(wpack[k].shape) if k in wpack else None}"
                             f" != {s}")
    hn = torch.empty_like(h)
    delta = torch.empty((b, hh, ww, _DELTA), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * len(WEIGHT_ORDER))(
        *[wpack[k].data_ptr() if k in wpack else None for k in WEIGHT_ORDER])
    lib = _build.load("gru_update")
    size = lib.gru_update_workspace_floats
    size.restype = ctypes.c_long
    size.argtypes = [ctypes.c_int] * 4
    ws = torch.empty(size(b, hh, ww, hd), dtype=torch.float32, device=dev)
    fn = lib.gru_update_forward
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
        raise RuntimeError(f"gru_update kernel launch failed: CUDA error {rc}")
    gru_update.launches += 1
    return hn, delta


gru_update.launches = 0
