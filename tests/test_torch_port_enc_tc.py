"""Rows 9, 15 and 16 on the tensor cores (``csrc/enc_conv_tc.cu``): layout
and numerics, on the CPU.

The kernel runs only on the card.  These tests hold what surrounds it:
its weight pack (``cuda_encoder.tc_pack``) unpacks exactly to the OIHW
weights' TF32 hi and lo planes; its launch geometry (``tc_geometry``)
covers every output once and matches the instances of the source; and an
emulation of its arithmetic (prep, mask after the prep, TF32 split; per
stage of 8 input channels a fresh sum of the 3xTF32 products over the 9
taps, added to the running total in fp32; the projection at the centre
tap; the output sums in the kernel's order) stays within the card's
tolerance of the plain versions, and, patched into the port's fused
stages, of the JAX package's stages in interpret mode.  A single TF32
pass and a mask before the prep are emulated too, to show that the
comparisons would see them.  Inputs are made with numpy from a seed.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from raftstereo_tpu.ops import pallas_encoder as pe
from raftstereo_tpu.ops import pallas_layer2 as pl2
from raftstereo_tpu_torch.ops import _build
from raftstereo_tpu_torch.ops import cuda_encoder as ce
from raftstereo_tpu_torch.ops import encoder_stage as es
from raftstereo_tpu_torch.ops.cuda_gru import tf32_round
from test_torch_port_encoder import (STAGE_TOL, _convs, _layer2_params,
                                     _nchw, _nhwc)
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse

# chip_smoke.py's ENC_TOL: each output within 1e-4 x max(1, |plain|) of
# the plain version; (B, C) output sums compared per pixel.
ENC_TOL = 1e-4


# ---------------------------------------------------------------- pack

def _unswizzle(pack):
    """Undo the pack's half swap: in rows whose output index has bit 2
    set, the two 4-channel halves trade places."""
    bn = pack.shape[-2]
    swap = ((torch.arange(bn) >> 2) & 1).bool()
    return torch.where(swap[:, None], pack.roll(4, -1), pack)


def _unpack(pack, cout, cin):
    """(hi, lo) OIHW planes (and the projection's (Cout, Cin) planes, or
    None) from a pack; everything past Cout and Cin must be zero."""
    nt, nk, taps, planes, bn, kc = pack.shape
    assert planes == 2 and kc == ce.TC_STAGE and taps in (9, 10)
    u = _unswizzle(pack).permute(3, 0, 4, 2, 1, 5).reshape(
        2, nt * bn, taps, nk * kc)                 # (plane, o, tap, c)
    assert not u[:, cout:].any() and not u[:, :, :, cin:].any()
    u = u[:, :cout, :, :cin]
    w = u[:, :, :9].reshape(2, cout, 3, 3, cin).permute(0, 1, 4, 2, 3)
    return w, (u[:, :, 9] if taps == 10 else None)


@pytest.mark.parametrize("cout,cin,inst", [(64, 64, "stage_conv"),
                                           (96, 64, "l2_entry"),
                                           (96, 96, "stage_conv"),
                                           (32, 20, "l2_entry"),
                                           (96, 96, "l2_conv")],
                         ids=["row9", "row15", "cin96", "ragged",
                              "row16_bn96"])
def test_pack_unpacks_to_oihw_tf32_planes(cout, cin, inst):
    """Every weight lands once, at its (tile, stage, tap, output, channel)
    place, as hi = ``tf32_round(w)`` and lo = ``tf32_round(w - hi)``;
    outputs past Cout and channels past Cin are zero.  Row 16's pack is
    one tile of 96 outputs, 12 stages of 8 channels."""
    proj = inst == "l2_entry"
    rng = np.random.default_rng(cout + cin)
    w = torch.from_numpy(rng.normal(size=(cout, cin, 3, 3))
                         .astype(np.float32))
    wp = torch.from_numpy(rng.normal(size=(cout, cin, 1, 1))
                          .astype(np.float32)) if proj else None
    bn = ce.TC_INSTANCES[inst][3]
    pack = ce.tc_pack(w, wp, bn)
    assert pack.shape == (-(-cout // bn), -(-cin // 8), 10 if proj else 9,
                          2, bn, 8)
    assert pack.dtype == torch.float32 and pack.is_contiguous()
    (hi, lo), pw = _unpack(pack, cout, cin)
    assert torch.equal(hi, tf32_round(w))
    assert torch.equal(lo, tf32_round(w - tf32_round(w)))
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    if proj:
        p = wp.reshape(cout, cin)
        assert torch.equal(pw[0], tf32_round(p))
        assert torch.equal(pw[1], tf32_round(p - tf32_round(p)))


# ------------------------------------------------------------ geometry

def _source_constants():
    """kTH, kKC and the instances (kInst: id -> (stride, MT, NT)) from the
    kernel source."""
    src = _build.sources()["enc_conv_tc"].read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    table = re.search(r"kInst\[(\d+)\] = \{(.*?)\n\};", src, re.S)
    inst = {int(m.group(4)): tuple(int(m.group(k)) for k in (1, 2, 3))
            for m in re.finditer(r"\{(\d+), (\d+), (\d+)\},\s*// (\d+):",
                                 table.group(2))}
    assert len(inst) == int(table.group(1))
    return const("kTH"), const("kKC"), inst


def _tile_geometry(inst):
    """The kernel's ``Geo`` for the instance of wrapper ``inst``: raw tile
    (RH, RW), stored plane width and size (PW, PS), stored pixels, and its
    pixel maps: ``spix`` of a raw tile pixel, ``pbase`` of an output
    pixel, ``toff`` of a tap."""
    th = ce.TC_TILE_H
    _, stride, tw, _ = ce.TC_INSTANCES[inst]
    rh, rw = (th - 1) * stride + 3, (tw - 1) * stride + 3
    pw = rw if stride == 1 else tw + 1
    ps = rh * rw if stride == 1 else (th + 1) * (tw + 1)

    def spix(lr, lc):
        if stride == 1:
            return lr * rw + lc
        return ((lr & 1) * 2 + (lc & 1)) * ps + (lr >> 1) * pw + (lc >> 1)

    def toff(dy, dx):
        if stride == 1:
            return dy * rw + dx
        return ((dy & 1) * 2 + (dx & 1)) * ps + (dy >> 1) * pw + (dx >> 1)

    def pbase(ly, lx):
        return ly * pw + lx

    npix = ps if stride == 1 else 4 * ps
    return rh, rw, npix, spix, pbase, toff


def test_geometry_matches_the_source():
    """Each wrapper's instance (id, stride, tile width, outputs per block)
    is the source's kInst entry of that id; row 16's is stride 1, 8x16
    pixels x 96 outputs."""
    th, kc, inst = _source_constants()
    assert (th, kc) == (ce.TC_TILE_H, ce.TC_STAGE)
    assert sorted(i for i, *_ in ce.TC_INSTANCES.values()) == sorted(inst)
    for iid, stride, tw, bn in ce.TC_INSTANCES.values():
        s, mt, nt = inst[iid]
        assert (stride, tw, bn) == (s, 8 * mt, 16 * nt)  # 4 x 2 warps
    assert ce.TC_INSTANCES["l2_conv"][1:] == (1, 16, 96)


# The instances by wrapper; ids by stride for rows 9 and 15.
INSTANCES = pytest.mark.parametrize(
    "inst", ["stage_conv", "l2_entry", "l2_conv"], ids=["1", "2", "l2_conv"])


@INSTANCES
def test_stored_tile_maps_every_tap_to_its_input(inst):
    """Every raw tile pixel has its own stored pixel, and the kernel's A
    rows for output (ly, lx) at tap (dy, dx), pbase + toff, are the stored
    pixel of raw input (S*ly + dy, S*lx + dx)."""
    rh, rw, npix, spix, pbase, toff = _tile_geometry(inst)
    stored = [spix(r, c) for r in range(rh) for c in range(rw)]
    assert len(set(stored)) == len(stored) and max(stored) < npix
    _, stride, tw, _ = ce.TC_INSTANCES[inst]
    for ly in range(ce.TC_TILE_H):
        for lx in range(tw):
            for dy in range(3):
                for dx in range(3):
                    assert (pbase(ly, lx) + toff(dy, dx)
                            == spix(stride * ly + dy, stride * lx + dx))


@INSTANCES
@pytest.mark.parametrize("h,w", [(13, 2), (9, 37), (21, 70), (19, 45),
                                 (9, 33), (14, 4), (17, 66), (30, 2),
                                 (40, 90), (576, 960), (320, 720)])
def test_tiles_cover_each_output_once(inst, h, w):
    """The wrapper's launch geometry at the card tests' hostile widths and
    the serving and training shapes: the output size is the plain conv's,
    and the nb tiles of 8 rows x tile width cover each output pixel
    exactly once (tiles past the edge only overhang)."""
    stride = ce.TC_INSTANCES[inst][1]
    ho, wo, tw, bn, nb = ce.tc_geometry(h, w, inst)
    want = F.conv2d(torch.zeros(1, 1, h, w), torch.zeros(1, 1, 3, 3),
                    stride=stride, padding=1).shape[2:]
    assert (ho, wo) == tuple(want)
    ty, tx = -(-ho // ce.TC_TILE_H), -(-wo // tw)
    assert nb == ty * tx
    assert (ty - 1) * ce.TC_TILE_H < ho <= ty * ce.TC_TILE_H
    assert (tx - 1) * tw < wo <= tx * tw


# ----------------------------------------------------------- emulation

def _split(v):
    hi = tf32_round(v)
    return hi, tf32_round(v - hi)


def _butterfly(v, masks):
    """``s += __shfl_xor_sync(s, m)`` for each m, over the last axis (the
    lanes); fp32, every lane ends with the same sum."""
    idx = torch.arange(v.shape[-1])
    for m in masks:
        v = v + v[..., idx ^ m]
    return v


def _kernel_sums(y, inst, warps_m=4):
    """(sum, sum of squares) over (H, W) of fp32 ``y`` in the kernel's
    order for the instance of wrapper ``inst``: per block, each lane over
    its pixels (m-tiles in order, rows g then g + 8), a butterfly over the
    8 lanes g of a channel, the ``warps_m`` pixel warps in order; then the
    stats kernel over the blocks (lane l sums blocks l, l + 32, ... in
    order, then a butterfly).  (Row 13's stem takes the 8x32 tile of
    ``stage_conv`` with its own ``warps_m``.)"""
    b, c, ho, wo = y.shape
    tw = ce.TC_INSTANCES[inst][2]
    mt_n = 8 * tw // (16 * warps_m)      # m-tiles per warp: 8 rows x tw
    ty, tx = -(-ho // 8), -(-wo // tw)
    yt = F.pad(y, (0, tx * tw - wo, 0, ty * 8 - ho))
    yt = yt.reshape(b, c, ty, 8, tx, tw).permute(0, 1, 2, 4, 3, 5)
    wm, i, half, g = torch.meshgrid(torch.arange(warps_m),
                                    torch.arange(mt_n), torch.arange(2),
                                    torch.arange(8), indexing="ij")
    mt = wm * mt_n + i
    ly = mt // (tw // 16)
    lx = (mt % (tw // 16)) * 16 + g + 8 * half
    v = yt[..., ly, lx]                  # (b, c, ty, tx, WM, MT, 2, 8)
    s1 = torch.zeros(v.shape[:5] + (8,))
    s2 = torch.zeros_like(s1)
    for ii in range(mt_n):
        for hh in range(2):
            e = v[..., ii, hh, :]
            s1 = s1 + e
            s2 = (e.double() * e.double() + s2.double()).float()  # fmaf
    out = []
    for s in (s1, s2):
        s = _butterfly(s, (1, 2, 4))[..., 0]           # lanes g: bits 2-4
        blk = s[..., 0]
        for w in range(1, warps_m):                    # pixel warps in order
            blk = blk + s[..., w]
        blk = blk.reshape(b, c, ty * tx)                  # block order
        nb = blk.shape[-1]
        lanes = torch.zeros(b, c, 32)
        for j in range(0, nb, 32):
            part = blk[..., j:j + 32]
            lanes[..., :part.shape[-1]] = lanes[..., :part.shape[-1]] + part
        out.append(_butterfly(lanes, (16, 8, 4, 2, 1))[..., 0])
    return out[0], out[1]


def emulate_conv(x, weight, bias, inst="stage_conv", aff=None, res=None,
                 res_aff=None, proj=None, want_stats=True, passes="3xtf32",
                 mask_after_prep=True, res_relu=True):
    """The arithmetic of the kernel instance of wrapper ``inst`` on the
    CPU: the prepped input (rounded as the plain version rounds it; the
    residual term without its relu when ``res_relu`` is False, row 16's
    kResProj), zero outside the image after the prep (before it with
    ``mask_after_prep=False``, as a TMA zero fill would leave it), split
    into TF32 hi and lo; per stage of 8 channels the products over the 9
    taps in float64 (the tensor cores' partial sum), rounded to fp32 and
    added to the fp32 total in stage order; + bias; the projection from
    the centre tap and the pack's tenth tap.  ``passes`` "tf32" keeps
    a_hi*b_hi alone.  Returns ``stage_conv``'s (and ``l2_conv``'s) ``(y,
    sums)`` or, with ``proj``, ``l2_entry``'s ``(y, yp, sums, projection
    sums)``."""
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    stride = ce.TC_INSTANCES[inst][1]
    ho, wo, _, bn, _ = ce.tc_geometry(h, w, inst)
    pack = ce.tc_pack(weight, None if proj is None else proj[0], bn)
    nt, nk, taps = pack.shape[:3]
    bw = _unswizzle(pack).permute(3, 1, 2, 5, 0, 4).reshape(
        2, nk, taps, 8, nt * bn).double()        # (plane, k, tap, ch, o)
    if mask_after_prep:
        t = x if aff is None else ce.prep(x, aff)
        if res is not None:
            t = torch.relu(ce.prep(res, res_aff, relu=res_relu) + t)
        t = F.pad(t, (1, 1, 1, 1))
    else:
        t = F.pad(x, (1, 1, 1, 1))
        t = t if aff is None else ce.prep(t, aff)
        if res is not None:
            t = torch.relu(ce.prep(F.pad(res, (1, 1, 1, 1)), res_aff,
                                   relu=res_relu) + t)
    t = F.pad(t, (0, 0, 0, 0, 0, nk * 8 - cin))
    a_hi, a_lo = (p.double().reshape(b, nk, 8, h + 2, w + 2)
                  for p in _split(t))

    def window(a, dy, dx):
        return a[..., dy:dy + stride * (ho - 1) + 1:stride,
                 dx:dx + stride * (wo - 1) + 1:stride]

    def products(k, tap_list, blk):
        out = 0.0
        for tap, (dy, dx) in zip(blk, tap_list):
            ah, al = window(a_hi[:, k], dy, dx), window(a_lo[:, k], dy, dx)
            bh, bl = bw[0, k, tap], bw[1, k, tap]
            if passes == "3xtf32":
                out = out + torch.einsum("bcyx,co->boyx", al, bh) \
                    + torch.einsum("bcyx,co->boyx", ah, bl)
            out = out + torch.einsum("bcyx,co->boyx", ah, bh)
        return out.float()

    taps9 = [(dy, dx) for dy in range(3) for dx in range(3)]
    acc = torch.zeros(b, nt * bn, ho, wo)
    accp = torch.zeros_like(acc)
    for k in range(nk):
        acc = acc + products(k, taps9, range(9))
        if proj is not None:
            accp = accp + products(k, [(1, 1)], [9])
    y = acc[:, :cout] + bias[:, None, None]
    sums = _kernel_sums(y, inst) if want_stats else None
    if proj is None:
        return y, sums
    yp = accp[:, :cout] + proj[1][:, None, None]
    return y, yp, sums, (_kernel_sums(yp, inst) if want_stats else None)


def emulated_stage_conv(x, aff, weight, bias, res=None, res_aff=None,
                        want_stats=True):
    return emulate_conv(x, weight, bias, "stage_conv", aff, res, res_aff,
                        want_stats=want_stats)


def emulated_l2_entry(t, weight, bias, proj_weight, proj_bias,
                      want_stats=True):
    return emulate_conv(t, weight, bias, "l2_entry",
                        proj=(proj_weight, proj_bias), want_stats=want_stats)


def emulated_l2_conv(x, aff, weight, bias, res=None, res_aff=None,
                     want_stats=True):
    return emulate_conv(x, weight, bias, "l2_conv", aff, res, res_aff,
                        want_stats=want_stats, res_relu=False)


def _rel_err(got, want, n):
    """Largest |got - want| / max(1, |want|) over the outputs, (B, C) sums
    divided by the pixel count ``n`` first (as ``chip_smoke.hold``)."""
    got = [g for g in _leaves(got)]
    want = [w for w in _leaves(want)]
    assert len(got) == len(want)
    err = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if g.dim() == 2:
            g, w = g / n, w / n
        err = max(err, float((g - w).abs().max())
                  / max(1.0, float(w.abs().max())))
    return err


def _leaves(out):
    if out is None:
        return []
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _leaves(o)]


def _randn(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _aff(rng, b, c):
    """A prep affine with positive shifts in every channel (zero padding
    before the prep would show at the border); channel 0's scale is a
    constant channel's rstd, 1/sqrt(1e-5)."""
    s = rng.uniform(0.5, 1.5, (b, c)).astype(np.float32)
    s[:, 0] = 1.0 / np.sqrt(1e-5)
    t = rng.uniform(0.05, 0.5, (b, c)).astype(np.float32)
    return torch.from_numpy(s), torch.from_numpy(t)


def _conv_case(form, cin, b, h, w, seed):
    """Inputs of one form: ``prep`` / ``res`` (row 9, channel 0 constant),
    ``entry`` (row 15, post-relu input), ``l2prep`` / ``l2res`` (row 16,
    the residual term without its relu).  Returns (kernel args, kwargs,
    plain function, pixels per output plane)."""
    rng = np.random.default_rng(seed)
    x = _randn(rng, b, cin, h, w)
    if form == "entry":
        wt = _randn(rng, 96, cin, 3, 3) * (2.0 / (9 * cin)) ** 0.5
        wp = _randn(rng, 96, cin, 1, 1) * (2.0 / cin) ** 0.5
        bias, bp = _randn(rng, 96) * 0.1, _randn(rng, 96) * 0.1
        t = torch.relu(x)
        n = float(((h - 1) // 2 + 1) * ((w - 1) // 2 + 1))
        return ((t, wt, bias, "l2_entry"), dict(proj=(wp, bp)),
                lambda **kw: ce.entry_plain(t, wt, bias, wp, bp, **kw), n)
    x[:, 0] = 0.25
    wt = _randn(rng, cin, cin, 3, 3) * (2.0 / (9 * cin)) ** 0.5
    bias = _randn(rng, cin) * 0.1
    aff = _aff(rng, b, cin)
    kw = dict(aff=aff)
    if form in ("res", "l2res"):
        kw.update(res=_randn(rng, b, cin, h, w), res_aff=_aff(rng, b, cin))
    if form == "l2res":
        kw["res_relu"] = False
    inst = "l2_conv" if form.startswith("l2") else "stage_conv"
    return ((x, wt, bias, inst), kw,
            lambda **k2: ce.conv_plain(x, wt, bias, 1, **kw, **k2),
            float(h * w))


CONV_CASES = [pytest.param("prep", 64, 2, 13, 37, 0, id="prep_c64_13x37"),
              pytest.param("res", 64, 1, 19, 45, 1, id="res_c64_19x45"),
              pytest.param("prep", 96, 3, 9, 33, 2, id="prep_c96_9x33"),
              pytest.param("entry", 64, 2, 14, 66, 3, id="entry_c64_14x66"),
              pytest.param("entry", 64, 1, 17, 37, 4, id="entry_c64_17x37"),
              pytest.param("l2prep", 96, 2, 13, 37, 6, id="l2prep_c96_13x37"),
              pytest.param("l2res", 96, 1, 19, 45, 7, id="l2res_c96_19x45"),
              pytest.param("l2res", 96, 3, 9, 33, 8, id="l2res_c96_9x33")]


@pytest.mark.parametrize("want_stats", [True, False],
                         ids=["sums", "no_sums"])
@pytest.mark.parametrize("form,cin,b,h,w,seed", CONV_CASES)
def test_3xtf32_emulation_within_enc_tol_of_plain(form, cin, b, h, w, seed,
                                                  want_stats):
    """The kernel's arithmetic within ``ENC_TOL`` of ``conv_plain`` /
    ``entry_plain`` (outputs, and sums per pixel), at hostile sizes: H
    not a multiple of the 8-row tile, W not of the tile width, odd inputs
    at stride 2, Cin 96 (12 stages, two output tiles of 64); row 16's
    instance (one tile of 96 outputs) in its prep and res_proj forms."""
    args, kw, plain, n = _conv_case(form, cin, b, h, w, seed)
    got = emulate_conv(*args, **kw, want_stats=want_stats)
    want = plain(want_stats=want_stats)
    err = _rel_err(got, want, n)
    assert err <= ENC_TOL, err
    if not want_stats:
        assert all(s is None for s in (got[1:2] if form != "entry"
                                        else got[2:]))


@pytest.mark.parametrize("form,cin,b,h,w,seed",
                         CONV_CASES[:1] + CONV_CASES[3:4])
def test_single_tf32_pass_is_reported_beside(form, cin, b, h, w, seed):
    """A single TF32 pass (a_hi*b_hi) at the same inputs: its error is
    reported beside the 3xTF32 one and is several times larger; the
    kernel takes three passes."""
    args, kw, plain, n = _conv_case(form, cin, b, h, w, seed)
    want = plain()
    e3 = _rel_err(emulate_conv(*args, **kw), want, n)
    e1 = _rel_err(emulate_conv(*args, **kw, passes="tf32"), want, n)
    print(f"{form}: 3xTF32 {e3:.2e}, single TF32 {e1:.2e} (tol {ENC_TOL})")
    assert e1 > 10 * e3


@pytest.mark.parametrize("form", ["prep", "res", "l2res"])
def test_mask_before_the_prep_misses_plain_at_the_border(form):
    """The mask trap: zeros put in before the prep (as TMA's fill would
    leave them) become relu(shift) > 0 at the border (for kResProj,
    relu(rt + relu(t)), also > 0), far outside the tolerance; the
    interior agrees."""
    cin = 96 if form == "l2res" else 64
    args, kw, plain, n = _conv_case(form, cin, 1, 12, 20, 5)
    y, _ = plain()
    good, _ = emulate_conv(*args, **kw)
    bad, _ = emulate_conv(*args, **kw, mask_after_prep=False)
    assert _rel_err(good, y, n) <= ENC_TOL
    assert _rel_err(bad, y, n) > 10 * ENC_TOL
    torch.testing.assert_close(bad[..., 1:-1, 1:-1], good[..., 1:-1, 1:-1])


# ------------------------------------------------ the stages against JAX

@pytest.fixture
def emulated(monkeypatch):
    """The port's fused stages with rows 9, 15 and 16 replaced by the
    emulation (the other wrappers take their plain versions)."""
    monkeypatch.setattr(ce, "stage_conv", emulated_stage_conv)
    monkeypatch.setattr(ce, "l2_entry", emulated_l2_entry)
    monkeypatch.setattr(ce, "l2_conv", emulated_l2_conv)


@pytest.mark.parametrize("stage,hw", [("stem_layer1", (16, 24)),
                                      ("fused_layer2", (16, 24)),
                                      ("fused_layer2", (14, 22))],
                         ids=["stem_layer1", "fused_layer2",
                              "fused_layer2_odd"])
def test_emulated_stages_match_jax(emulated, stage, hw):
    """``stem_layer1`` (four row-9 convs, the block boundary's res form)
    and ``fused_layer2`` (row 15's entry, then row 16's three convs in
    their prep and res_proj forms) at the model's widths (64 in, 96 out),
    2 images of 16x24, and layer2 at 14x22 (a 7x11 output: odd width and
    height), the JAX stages in interpret mode: within the stage tests'
    tolerance.  The stem's input is centred below 0, so every channel's
    prep shift is positive."""
    rng = np.random.default_rng(11)
    h, w = hw
    with pe.override_fused_stem(True), pl2.override_fused_layer2(True):
        if stage == "stem_layer1":
            y1 = (rng.normal(size=(2, h, w, 64)) * 2
                  - 0.7).astype(np.float32)
            jp, tp = _convs(rng, ("c10", "c11", "c20", "c21"), 3, 64, 64)
            want = jax.jit(pe.stem_layer1)(jnp.asarray(y1), jp)
            got = es.stem_layer1(_nchw(y1), tp)
        else:
            t_in = np.abs(rng.normal(size=(2, h, w, 64))).astype(np.float32)
            jp, tp = _layer2_params(rng, 64, 96)
            want = jax.jit(pl2.fused_layer2)(jnp.asarray(t_in), jp)
            got = es.fused_layer2(_nchw(t_in), tp)
    want, got = np.asarray(want), _nhwc(got)
    assert got.shape == want.shape and want.max() > 0.5
    np.testing.assert_allclose(got, want, **STAGE_TOL)
