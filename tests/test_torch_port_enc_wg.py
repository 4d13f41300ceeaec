"""Rows 9, 15 and 16's bf16 forms on ``csrc/enc_conv_wg.cu`` (layer1's
and layer2's 3x3 convs as one persistent ``wgmma`` implicit GEMM, the
output width N a template parameter), emulated on the CPU.

There is no compiler or card here, so the kernel's addressing and
arithmetic are emulated in numpy from its source's constants:

(a) the geometry (instances, tile, halo planes, stages, shared memory)
    against the source and the wrappers' Python
    (``cuda_encoder.WG_INSTANCES``);
(b) the weight pack read back through the kernel's B descriptors (K-major,
    no swizzle: start, LBO, SBO) is the bf16 OIHW weights;
(c) the producer's stage (16-byte vector loads, prep, mask, registers
    rotated by lane, ``stmatrix.x4.trans``, scalar edge columns) read
    through each tap's A descriptor is the prepped, zero-padded input at
    the right pixels, at both strides, in every prep mode, ragged sizes
    included;
(d) the persistent tile walk covers every output tile once;
(e) the kernel's accumulation (all of K in one fp32 chain, each k-step's
    16 products added with truncation, the pessimistic model of the
    tensor cores' add) is within the card's gate of the plain version and
    of the JAX kernels at ``dt=bfloat16`` (interpret mode, as
    tests/test_torch_port_enc_bf16.py runs them); the producers' bf16x2
    prep is the per-op rounding.
"""

import re

import numpy as np
import pytest
import torch
from test_torch_port_enc_bf16 import (BF, CO, JBF, B, C, H, W, _aff, _bf,
                                      _check_out, _check_sums, _conv,
                                      _l2_weights, _np, _rbf, _t,
                                      _unpack_sums, kernel_prep)
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse

from raftstereo_tpu.ops import pallas_encoder as pe
from raftstereo_tpu.ops import pallas_layer2 as pl2
from raftstereo_tpu_torch.ops import _build
from raftstereo_tpu_torch.ops import cuda_encoder as ce

SRC = _build.source_text("enc_conv_wg")
TEXT = " ".join(SRC.split())
ULP = 2.0 ** -7
# The card's gate (chip_smoke.py ENC_BF16_ULPS, ENC_BF16_EQUAL, ENC_TOL):
# within 1 bf16 ulp of max(1, |plain|), at least 99% equal, fp32 sums
# within 1e-4 of max(1, |plain|) per pixel.
GATE_ULPS, GATE_EQUAL, GATE_SUMS = 1.0, 0.99, 1e-4
SMS = 132  # an H100 SXM's SMs: the grid of the persistent launch


def const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


KKC, KTW, OUT_PITCH = const("kKC"), const("kTW"), const("kOutPitch")
# The source's instances (kInst): (stride, mode, Cout, NK, MR).
KINST = [(int(st), mode, int(n), int(nk), int(mr)) for st, mode, n, nk, mr
         in re.findall(r"\{(\d), k(\w+), (\d+), (\d+), (\d)\},", SRC)]
# Each wrapper's modes.
MODES = {"stage_conv": ("Prep", "Res"), "l2_conv": ("Prep", "ResProj"),
         "l2_entry": ("None",)}


def kblk(n: int) -> int:
    """Bytes of a (k-step, tap) weight block at N outputs."""
    return 2 * n * 16


def geo(stride: int, proj: bool, nk: int, n: int, mr: int) -> dict:
    """``WgGeo<S, PROJ, NK, N, MR>`` of the source."""
    th = 2 * mr
    pw = KTW + 2 if stride == 1 else KTW + 1
    ph = th + 2 if stride == 1 else th + 1
    npl = 1 if stride == 1 else 4
    half = npl * ph * pw * 16
    taps = 10 if proj else 9
    rh = th + 2 if stride == 1 else 2 * th + 1
    upr = stride * KTW // 32
    nside = 2 if stride == 1 else 1
    kw = nk * taps * kblk(n)
    fixed = kw + 2 * n * OUT_PITCH
    stages = min(4, (232448 - fixed - 128) // (2 * half))
    return dict(mr=mr, th=th, pw=pw, ph=ph, half=half, stage=2 * half,
                taps=taps, rh=rh, upr=upr, nu=rh * 2 * upr,
                nside=nside, ne=rh * 2 * nside, kw=kw, stages=stages,
                smem=fixed + stages * 2 * half + 8 * (2 * stages + 1))


def wrapper_geo(name: str) -> dict:
    """The geometry of wrapper ``name``'s instance."""
    stride, _, max_cin, cout = ce.WG_INSTANCES[name]
    return geo(stride, stride == 2, max_cin // KKC, cout,
               ce.WG_INSTANCES[name][1] // 2)


# ---------------------------------------------------------- (a) geometry

def test_geometry_matches_the_source():
    """The wrappers' (stride, tile rows, largest Cin, Cout) are the
    source's instances (``kInst``: TH = 2 MR, Cin <= 16 NK, N = Cout; the
    projection at stride 2), one per (stride, mode, Cout); the constants
    and the ``WgGeo`` formulas are the source's; each instance's weights,
    staging and at least 2 stages fit 227 KB."""
    assert (KKC, KTW) == (ce.WG_STAGE, ce.WG_TILE_W)
    for text in ("MR = MR_;", "TH = 2 * MR;", "kBlk = 2 * N * 16;",
                 "PW = S == 1 ? kTW + 2 : kTW + 1;",
                 "PH = S == 1 ? TH + 2 : TH + 1;",
                 "NPL = S == 1 ? 1 : 4;", "kHalf = NPL * PH * PW * 16;",
                 "kTaps = PROJ ? 10 : 9;", "kW = NK * kTaps * kBlk;",
                 "RH = S == 1 ? TH + 2 : 2 * TH + 1;",
                 "UPR = S * kTW / 32;", "NSIDE = S == 1 ? 2 : 1;",
                 "kOut = N * kOutPitch;", "kFixed = kW + 2 * kOut;",
                 "kStages = kStages0 > 4 ? 4 : kStages0;",
                 "kSmem = kBar + 8 * (2 * kStages + 1);",
                 "wg_desc(sst, G::kHalf, 128)", "wg_desc(sw, N * 16, 128)",
                 "constexpr bool PROJ = in.stride == 2;",
                 "const int th = 2 * kInst[inst].mr;"):
        assert text in TEXT, text
    assert len({(st, m, n) for st, m, n, _, _ in KINST}) == len(KINST)
    assert sorted((st, m, n) for st, m, n, _, _ in KINST) == sorted(
        (ce.WG_INSTANCES[name][0], m, ce.WG_INSTANCES[name][3])
        for name, modes in MODES.items() for m in modes)
    for stride, mode, n, nk, mr in KINST:
        name = next(k for k, v in ce.WG_INSTANCES.items()
                    if v[0] == stride and v[3] == n)
        assert ce.WG_INSTANCES[name] == (stride, 2 * mr, 16 * nk, n), name
        g = geo(stride, stride == 2, nk, n, mr)
        assert g["stages"] >= 2 and g["smem"] <= 232448
        assert g["nu"] % 4 == 0 and g["ne"] <= 128
    assert (wrapper_geo("l2_conv")["stages"], wrapper_geo("l2_entry")
            ["stages"], wrapper_geo("stage_conv")["stages"]) == (3, 3, 4)


# ------------------------------------------------------ (b) B descriptors

def _u16(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().reshape(-1).view(
        np.uint16)


def desc_matrix(image: np.ndarray, start: int, lbo: int, sbo: int,
                rows: int) -> np.ndarray:
    """What a K-major, no-swizzle ``wgmma`` descriptor reads from a
    shared-memory image of b16 values (byte offsets): (rows, 16), element
    (r, k) at start + (r // 8) sbo + (r % 8) 16 + (k // 8) lbo + (k % 8)
    2.  The hardware takes any 16-byte aligned start."""
    assert start % 16 == 0 and lbo % 16 == 0 and sbo % 16 == 0
    r, k = np.arange(rows)[:, None], np.arange(16)[None, :]
    off = start + (r // 8) * sbo + (r % 8) * 16 + (k // 8) * lbo + (k % 8) * 2
    return image[off // 2]


@pytest.mark.parametrize("cout,cin,proj", [
    (96, 96, False), (96, 64, True), (96, 20, True), (96, 40, False),
    (64, 64, False), (64, 36, False)],
    ids=["row16", "row15", "ragged15", "ragged16", "row9", "ragged9"])
def test_pack_through_b_descriptors_is_the_weights(cout, cin, proj):
    """``wg_pack`` read through the kernel's B descriptor of each (k-step,
    tap) (start (k * taps + tap) * 32 Cout, LBO Cout * 16, SBO 128; the
    projection the tenth tap) is the bf16 weights, zero past Cin."""
    rng = np.random.default_rng(cin + cout)
    w = torch.from_numpy(rng.normal(size=(cout, cin, 3, 3))
                         .astype(np.float32))
    wp = (torch.from_numpy(rng.normal(size=(cout, cin, 1, 1))
                           .astype(np.float32)) if proj else None)
    pack = ce.wg_pack(w, wp)
    nk, taps = -(-cin // KKC), 10 if proj else 9
    assert pack.dtype == BF and pack.shape == (nk, taps, 2, cout, 8)
    image = _u16(pack)
    wb = _u16(w.to(BF)).reshape(cout, cin, 3, 3)
    for k in range(nk):
        for tap in range(taps):
            got = desc_matrix(image, (k * taps + tap) * kblk(cout),
                              cout * 16, 128, cout)
            want = np.zeros((cout, 16), np.uint16)
            c1 = min(cin, 16 * k + 16)
            src = (_u16(wp.to(BF)).reshape(cout, cin) if tap == 9
                   else wb[:, :, tap // 3, tap % 3])
            want[:, :c1 - 16 * k] = src[:, 16 * k:c1]
            np.testing.assert_array_equal(got, want, err_msg=f"{k} {tap}")


# ------------------------------------------------- (c) the producer, A

def _bits(v: np.ndarray) -> np.ndarray:
    """bf16-valued fp32 -> its bf16 bits."""
    return (np.asarray(v, np.float32).view(np.uint32) >> 16).astype(
        np.uint32)


def stmatrix_x4_trans(image, regs, addrs):
    """``stmatrix.sync.aligned.m8n8.x4.trans.shared.b16``: memory row j of
    matrix i (address from lane 8i + j) receives fragment column j, whose
    row g lane 4g + j // 2 holds in register i (element j % 2)."""
    for i in range(4):
        for j in range(8):
            a = addrs[8 * i + j] // 2
            for g in range(8):
                image[a + g] = (regs[4 * g + j // 2, i] >> (16 * (j % 2))) \
                    & 0xFFFF


def pair_px(stride: int, pi: int, e: int) -> int:
    return 2 * pi + e if stride == 1 else (pi & 1) * 4 + (pi >> 1) + 2 * e


def slot(stride, g, lr, lc):
    if stride == 1:
        return lr * g["pw"] + lc
    return (((lr & 1) * 2 + (lc & 1)) * g["ph"] + (lr >> 1)) * g["pw"] \
        + (lc >> 1)


def produce_stage(value, shape, b, k, ty, tx, stride, g):
    """The producer's stage of k-step ``k`` for tile (ty, tx) of image
    ``b``: a b16 image of 2 * kHalf bytes.  ``shape`` the input's (B, Cin,
    H, W); ``value(b, c, gy, gx)`` the kernel's prepped value of the raw
    input there, called only where the producer's mask lets it read."""
    _, cin, h, win = shape
    image = np.zeros(g["stage"] // 2, np.uint32)
    iy0, ix0 = ty * g["th"] * stride - 1, tx * KTW * stride - 1
    for warp in range(4):
        for i in range(g["nu"] // 4):
            un = warp + 4 * i
            lr, h_, uc = un // (2 * g["upr"]), (un // g["upr"]) & 1, \
                un % g["upr"]
            regs = np.zeros((32, 4), np.uint32)
            gy = iy0 + lr
            for ln in range(32):
                c = k * KKC + 8 * h_ + (ln >> 2)
                gx = ix0 + 1 + 32 * uc + 8 * (ln & 3)
                ok = 0 <= gy < h and c < cin
                v = np.zeros(8, np.float32)
                for e in range(8):
                    if ok and gx + e < win:
                        v[e] = value(b, c, gy, gx + e)
                pairs = [_bits(v[pair_px(stride, pi, 0)])
                         | (_bits(v[pair_px(stride, pi, 1)]) << 16)
                         for pi in range(4)]
                # register i <- pair (i + lane % 4) % 4
                regs[ln] = [pairs[(i2 + (ln & 3)) & 3] for i2 in range(4)]
            addrs = []
            for ln in range(32):
                mi, j = ln >> 3, ln & 7
                pi = (mi + (j >> 1)) & 3
                lc = 32 * uc + 8 * (j >> 1) + pair_px(stride, pi, j & 1) + 1
                addrs.append(h_ * g["half"] + slot(stride, g, lr, lc) * 16)
            stmatrix_x4_trans(image, regs, addrs)
    for tid in range(g["ne"]):  # the edge columns
        lr, h_, side = tid // (2 * g["nside"]), (tid // g["nside"]) & 1, \
            tid % g["nside"]
        lc = KTW + 1 if side else 0
        gy, gx = iy0 + lr, ix0 + lc
        ok = 0 <= gy < h and 0 <= gx < win
        for e in range(8):
            c = k * KKC + 8 * h_ + e
            v = value(b, c, gy, gx) if ok and c < cin else 0.0
            image[(h_ * g["half"] + slot(stride, g, lr, lc) * 16) // 2 + e] \
                = _bits(np.float32(v))
    return image


def tap_off(stride, g, oyl, dy, dx):
    if stride == 1:
        return ((oyl + dy) * g["pw"] + dx) * 16
    return ((((dy & 1) * 2 + (dx & 1)) * g["ph"] + oyl + (dy >> 1)) * g["pw"]
            + (dx >> 1)) * 16


@pytest.mark.parametrize("name,mode,stride,b,cin,h,w", [
    ("l2_conv", "prep", 1, 2, 20, 9, 70),
    ("l2_conv", "res_proj", 1, 1, 16, 5, 37),
    ("l2_entry", "none", 2, 2, 20, 7, 150),
    ("l2_entry", "none", 2, 1, 16, 3, 9),
    ("stage_conv", "prep", 1, 1, 36, 10, 67),
    ("stage_conv", "res", 1, 2, 20, 6, 72)],
    ids=["prep", "res_proj", "entry", "entry_small", "stage_prep",
         "stage_res"])
def test_a_descriptors_read_the_prepped_input(name, mode, stride, b, cin, h,
                                              w):
    """Every tap's A window (64 consecutive pixels of one plane) of every
    output row of each tile, read through its descriptor (start the tap's
    offset, LBO the channel half, SBO 128) from the stage the producer
    stores, is the prepped input at (S oy + dy - 1, S ox + dx - 1), zero
    outside the image AFTER the prep (positive shifts: a zero before the
    prep would read relu(t) > 0) and past Cin; ragged H, W and Cin; at
    each wrapper's tile rows (rows 9 and 16: 4, row 15: 2)."""
    rng = np.random.default_rng(h * w)
    x = (rng.normal(size=(b, cin, h, w)) * 2 + 0.3).astype(np.float32)
    x = _np(torch.from_numpy(x).to(BF))
    r = _np(torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)
                             * 2 - 0.3).to(BF))
    s, t = (rng.uniform(0.5, 1.5, (b, cin)).astype(np.float32),
            rng.uniform(0.05, 0.5, (b, cin)).astype(np.float32))
    rs, rt = (rng.uniform(0.5, 1.5, (b, cin)).astype(np.float32),
              rng.uniform(-0.5, 0.5, (b, cin)).astype(np.float32))

    def value(bb, c, gy, gx):  # the kernel's prep2, one element
        v = x[bb, c, gy, gx]
        if mode == "none":
            return v
        v = kernel_prep(v, s[bb, c], t[bb, c])
        if mode != "prep":  # kRes: relu on both terms; kResProj: not on r's
            u = kernel_prep(r[bb, c, gy, gx], rs[bb, c], rt[bb, c],
                            relu=mode == "res")
            v = np.maximum(_rbf(u + v), 0)
        return np.float32(v)

    # the whole prepped input, zero-padded after the prep (the reference)
    xt, st = torch.from_numpy(x).to(BF), (torch.from_numpy(s),
                                           torch.from_numpy(t))
    tp = x if mode == "none" else _np(ce.prep(xt, st))
    if mode in ("res", "res_proj"):
        tp = _np(torch.relu(ce.prep(torch.from_numpy(r).to(BF),
                                    (torch.from_numpy(rs),
                                     torch.from_numpy(rt)),
                                    relu=mode == "res")
                            + ce.prep(xt, st)))
    nk = -(-cin // KKC)
    pad = np.zeros((b, nk * KKC, h + 4 * stride + 8,
                    w + 2 * KTW * stride + 8), np.float32)
    pad[:, :cin, 1:h + 1, 1:w + 1] = tp
    g = wrapper_geo(name)
    ho, wo, nb = ce.wg_geometry(h, w, name)
    tiles_w = -(-wo // KTW)
    for bb in range(b):
        for rem in range(nb):
            ty, tx = divmod(rem, tiles_w)
            for k in range(nk):
                image = produce_stage(value, x.shape, bb, k, ty, tx, stride,
                                      g)
                for oyl in range(g["th"]):
                    oy = ty * g["th"] + oyl
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        got = desc_matrix(image, tap_off(stride, g, oyl, dy,
                                                         dx), g["half"], 128,
                                          64)
                        ys = stride * oy + dy
                        xs = stride * (tx * KTW + np.arange(64)) + dx
                        want = pad[bb, 16 * k:16 * k + 16, ys, xs]  # (64, 16)
                        np.testing.assert_array_equal(
                            got, _bits(want), err_msg=f"{rem} {k} {oyl} {tap}")


# --------------------------------------------------------- (d) tile walk

@pytest.mark.parametrize("name,b,h,w", [
    ("l2_conv", 2, 288, 480), ("l2_conv", 12, 160, 360),
    ("l2_entry", 2, 576, 960), ("l2_entry", 12, 320, 720),
    ("l2_conv", 1, 37, 53), ("l2_entry", 3, 41, 70), ("l2_conv", 2, 1, 2),
    ("stage_conv", 2, 576, 960), ("stage_conv", 1, 576, 960),
    ("stage_conv", 2, 288, 480), ("stage_conv", 12, 320, 720),
    ("stage_conv", 3, 45, 131)],
    ids=["serve16", "train16", "serve15", "train15", "ragged16", "ragged15",
         "tiny", "serve9", "cnet9", "ds3_9", "train9", "ragged9"])
def test_persistent_walk_covers_each_tile_once(name, b, h, w):
    """Blocks min(tiles, SMs) walk t = block, + grid, ...: every tile of
    every image exactly once, its partials row t = image * nb + tile; the
    tiles cover every output pixel once, and the overhang of the last
    tile of each axis is at most 7% at the path shapes."""
    ho, wo, nb = ce.wg_geometry(h, w, name)
    th = ce.WG_INSTANCES[name][1]
    total = b * nb
    grid = min(total, SMS)
    walked = [t for blk in range(grid) for t in range(blk, total, grid)]
    assert sorted(walked) == list(range(total))
    tiles_w = -(-wo // KTW)
    cover = np.zeros((b, -(-ho // th) * th, tiles_w * KTW), np.int32)
    for t in walked:
        img, rem = divmod(t, nb)
        ty, tx = divmod(rem, tiles_w)
        cover[img, ty * th:(ty + 1) * th, tx * KTW:(tx + 1) * KTW] += 1
    assert (cover == 1).all()
    if h >= 160:
        assert cover[0].size / (ho * wo) - 1 <= 0.07


# ------------------------------------------------------ (e) arithmetic

def trunc32(v: np.ndarray) -> np.ndarray:
    """float64 -> fp32 rounded toward zero."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def emulate_wg(t, weight, bias, stride, proj=None):
    """The kernel's arithmetic on the prepped input ``t`` (bf16-valued,
    (B, Cin, H, W)): per output, k-steps of 16 channels in order, the 9
    taps in order (the projection's one tap, its own chain), each 16 exact
    products summed (float64) and added to the fp32 chain with truncation;
    the bf16 bias added in fp32; (bf16 y, fp32 y[, bf16 yp, fp32 yp])."""
    t = torch.from_numpy(np.asarray(t, np.float32)).double()
    b, cin, h, w = t.shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    tp = torch.nn.functional.pad(t, (1, 1, 1, 1))
    wd = weight.to(BF).double()

    def chain(taps):
        acc = np.zeros((b, weight.shape[0], ho, wo), np.float32)
        for c0 in range(0, cin, KKC):
            for wt, dy, dx in taps:
                win = tp[:, c0:c0 + KKC, dy:dy + stride * (ho - 1) + 1:stride,
                         dx:dx + stride * (wo - 1) + 1:stride]
                grp = torch.einsum("oc,bchw->bohw", wt[:, c0:c0 + KKC], win)
                acc = trunc32(acc.astype(np.float64) + grp.numpy())
        return acc

    y = chain([(wd[:, :, dy, dx], dy, dx) for dy in range(3)
               for dx in range(3)])
    y = y + bias.to(BF).float().numpy()[:, None, None]
    out = [torch.from_numpy(y).to(BF), y]
    if proj is not None:
        pw, pb = proj
        yp = chain([(pw.to(BF).double()[:, :, 0, 0], 1, 1)])
        yp = yp + pb.to(BF).float().numpy()[:, None, None]
        out += [torch.from_numpy(yp).to(BF), yp]
    return out


def _gate(got, want):
    g, wv = _np(got), _np(want)
    assert np.abs(wv).max() > 0.5
    assert (np.abs(g - wv) / np.maximum(1, np.abs(wv))).max() <= GATE_ULPS \
        * ULP
    assert np.mean(g == wv) >= GATE_EQUAL


def _sums_gate(y32, sums, n):
    want = [_np(s) for s in sums]
    got = ce.stats_plain(torch.from_numpy(y32))
    for g_, w_ in zip(got, want):
        err = np.abs(_np(g_) - w_).max() / n
        assert err <= GATE_SUMS * max(1.0, np.abs(w_).max() / n)


@pytest.mark.parametrize("form", ["prep", "res_proj", "entry", "stage_prep",
                                  "stage_res"])
def test_one_chain_emulation_within_the_card_gate(form):
    """The one-chain, truncating accumulation at layer2's widths (96 -> 96,
    64 -> 96) and layer1's (64 -> 64, row 9: prep and the residual form
    with a relu on both terms) against ``conv_plain`` in bf16: within 1
    ulp, at least 99% equal, fp32 sums within 1e-4 per pixel."""
    rng = np.random.default_rng({"prep": 1, "res_proj": 2, "entry": 3,
                                 "stage_prep": 6, "stage_res": 7}[form])
    stride, cin = (2, 64) if form == "entry" else (1, 96)
    kn = 96
    if form.startswith("stage"):
        cin = kn = 64
    b, h, w = 2, 14, 26
    x = torch.from_numpy((rng.normal(size=(b, cin, h, w)) * 2 + 0.3)
                         .astype(np.float32)).to(BF)
    r = torch.from_numpy((rng.normal(size=(b, cin, h, w)) * 2 - 0.3)
                         .astype(np.float32)).to(BF)
    wt = torch.from_numpy((rng.normal(size=(kn, cin, 3, 3))
                           * np.sqrt(2 / (9 * cin))).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=kn).astype(np.float32) * 0.1)
    aff = (torch.from_numpy(rng.uniform(0.5, 1.5, (b, cin))
                            .astype(np.float32)),
           torch.from_numpy(rng.uniform(0.05, 0.5, (b, cin))
                            .astype(np.float32)))
    if form == "entry":
        t = torch.relu(x)
        wp = torch.from_numpy((rng.normal(size=(kn, cin, 1, 1))
                               * np.sqrt(2 / cin)).astype(np.float32))
        bp = torch.from_numpy(rng.normal(size=kn).astype(np.float32) * 0.1)
        y, y32, yp, yp32 = emulate_wg(_np(t), wt, bias, 2, (wp, bp))
        c1, p, s1, sp = ce.entry_plain(t, wt, bias, wp, bp)
        n = float(c1.shape[2] * c1.shape[3])
        _gate(y, c1)
        _gate(yp, p)
        _sums_gate(y32, s1, n)
        _sums_gate(yp32, sp, n)
        return
    kw = dict(aff=aff)
    tt = ce.prep(x, aff)
    if form in ("res_proj", "stage_res"):
        relu = form == "stage_res"
        raff = (aff[0].flip(1).contiguous(), aff[1].flip(1).contiguous() - .4)
        kw.update(res=r, res_aff=raff, res_relu=relu)
        tt = torch.relu(ce.prep(r, raff, relu=relu) + tt)
    y, y32 = emulate_wg(_np(tt), wt, bias, 1)
    want, sums = ce.conv_plain(x, wt, bias, 1, **kw)
    _gate(y, want)
    _sums_gate(y32, sums, float(h * w))


def test_one_chain_emulation_matches_the_jax_entry_kernel():
    """Row 15's emulated arithmetic against ``_l2_entry_kernel`` at
    ``dt=bfloat16`` (interpret mode) on the packed view of a post-relu
    input: both outputs within 1 ulp, at least 99% equal, sums within
    1e-5 per pixel."""
    rng = np.random.default_rng(4)
    t_in = abs(_bf(rng, (B, H, W, C)))
    _, tp, packed = _l2_weights(rng)
    c1, p, s1a, s1b, spa, spb = pl2._l2_entry(pe.pack_view(t_in), *packed,
                                              JBF)
    y, y32, yp, yp32 = emulate_wg(_np(_t(t_in)), *tp["c1"], 2, tp["proj"])
    nhwc = (0, 2, 3, 1)
    for got, want in ((y, c1), (yp, p)):
        g, wv = _np(got).transpose(nhwc), _np(want)
        assert (np.abs(g - wv) / np.maximum(1, np.abs(wv))).max() <= ULP
        assert np.mean(g == wv) >= GATE_EQUAL
    n = float(H // 2 * (W // 2))
    _check_sums(ce.stats_plain(torch.from_numpy(y32)),
                [s1a[:, 0], s1b[:, 0]], n)
    _check_sums(ce.stats_plain(torch.from_numpy(yp32)),
                [spa[:, 0], spb[:, 0]], n)


@pytest.mark.parametrize("form", ["prep", "res_proj"])
def test_one_chain_emulation_matches_the_jax_conv_kernel(form):
    """Row 16's emulated arithmetic against ``_l2_conv_kernel`` /
    ``_l2_conv_res_kernel`` at ``dt=bfloat16`` (interpret mode): within
    1 ulp, at least 99% equal, sums within 1e-5 per pixel."""
    rng = np.random.default_rng(5)
    h2, w2 = H // 2, W // 2
    x = _bf(rng, (B, h2, w2, CO), 2.0, 0.3)
    p = _bf(rng, (B, h2, w2, CO), 2.0, -0.3)
    (ta, _, fa), (tr, _, fr) = _aff(rng, B, CO), _aff(rng, B, CO, False)
    jp, (wt, bt) = _conv(rng, 3, CO, CO)
    res = form == "res_proj"
    y, s1, s2 = pl2._l2_conv(x, fa, pl2.pack_weights3(jp["kernel"])
                             .astype(JBF), jp["bias"].astype(JBF), JBF,
                             res=p if res else None,
                             res_aff=fr if res else None)
    tt = ce.prep(_t(x), ta)
    if res:
        tt = torch.relu(ce.prep(_t(p), tr, relu=False) + tt)
    got, y32 = emulate_wg(_np(tt), wt, bt, 1)
    g, wv = _np(got).transpose(0, 2, 3, 1), _np(y)
    assert np.abs(wv).max() > 0.5
    assert (np.abs(g - wv) / np.maximum(1, np.abs(wv))).max() <= ULP
    assert np.mean(g == wv) >= GATE_EQUAL
    _check_sums(ce.stats_plain(torch.from_numpy(y32)),
                [s1[:, 0], s2[:, 0]], float(h2 * w2))


@pytest.mark.parametrize("form", ["prep", "res"])
def test_one_chain_emulation_matches_the_jax_stage_kernel(form):
    """Row 9's emulated arithmetic against ``_enc_conv_kernel`` /
    ``_enc_conv_res_kernel`` at ``dt=bfloat16`` (interpret mode, through
    ``pallas_encoder._enc_conv`` on the packed view, as
    tests/test_torch_port_enc_bf16.py runs it): within 1 ulp, at least 99%
    equal, sums within 1e-5 per pixel; shifts > 0, so a zero padded before
    the prep would show at the border."""
    rng = np.random.default_rng(8)
    x = _bf(rng, (B, H, W, C), 2.0, 0.3)
    r = _bf(rng, (B, H, W, C), 2.0, -0.4)
    (ta, pa, _), (tr, pr, _) = _aff(rng, B, C), _aff(rng, B, C)
    jp, (wt, bt) = _conv(rng, 3, C, C)
    res = form == "res"
    y, sums = pe._enc_conv(pe.pack_view(x), pa,
                           pe.pack_weights(jp["kernel"]).astype(JBF),
                           pe.pack_vec(jp["bias"]).astype(JBF),
                           res=pe.pack_view(r) if res else None,
                           res_stats=pr if res else None)
    tt = ce.prep(_t(x), ta)
    if res:
        tt = torch.relu(ce.prep(_t(r), tr) + tt)
    got, y32 = emulate_wg(_np(tt), wt, bt, 1)
    _check_out(got, pe.unpack_view(y))
    _check_sums(ce.stats_plain(torch.from_numpy(y32)),
                _unpack_sums(sums, C), float(H * W))


def _bf16_once(v: np.ndarray) -> np.ndarray:
    """float64 -> the nearest bf16 (ties to even), rounded once."""
    m, e = np.frexp(v)
    return np.ldexp(np.round(m * 256.0), e - 8)


def test_bf16x2_prep_is_the_per_op_rounding():
    """The producers prep in bf16x2 (``mul.rn``, ``add.rn``, ``max.NaN``:
    each op rounded to bf16 once); ``prep_bf16`` rounds each fp32 op to
    bf16, as the JAX kernels do.  The two agree on every input, since an
    fp32 intermediate (24 bits) makes double rounding to 8 bits
    innocuous: checked on seeded inputs over a wide range of exponents, in
    the prep and residual-projection forms."""
    assert ("relu2(add2(mul2(x, s), t))" in TEXT
            and "relu2(add2(add2(mul2(r, rs), rt), v))" in TEXT)
    rng = np.random.default_rng(20)
    n = 200_000

    def bf(scale):
        v = rng.normal(size=n) * np.exp2(rng.integers(-scale, scale, n))
        return _bf16_once(v)

    x, s, t, r, rs, rt = bf(20), bf(6), bf(20), bf(20), bf(6), bf(20)
    once = np.maximum(_bf16_once(_bf16_once(x * s) + t), 0)
    res = np.maximum(_bf16_once(_bf16_once(_bf16_once(r * rs) + rt) + once),
                     0)
    got = kernel_prep(x.astype(np.float32), s, t)
    np.testing.assert_array_equal(got, once.astype(np.float32))
    u = kernel_prep(r.astype(np.float32), rs, rt, relu=False)
    np.testing.assert_array_equal(np.maximum(_rbf(u + got), 0),
                                  res.astype(np.float32))


def test_bf16x2_res_prep_is_the_per_op_rounding():
    """Row 9's residual form in bf16x2 (``kRes``: relu(relu(r*rs + rt) +
    relu(x*s + t)), a relu on both terms, each op rounded to bf16 once)
    against ``prep_bf16``'s per-op fp32 rounding and the plain version's
    bf16 ops, on seeded inputs over a wide range of exponents."""
    for text in ("if constexpr (MODE == kRes) v = relu2(add2(relu2(add2("
                 "mul2(r, rs), rt)), v));",
                 "if constexpr (MODE == kResProj) v = relu2(add2(add2("
                 "mul2(r, rs), rt), v));"):
        assert text in TEXT, text
    rng = np.random.default_rng(21)
    n = 200_000

    def bf(scale):
        v = rng.normal(size=n) * np.exp2(rng.integers(-scale, scale, n))
        return _bf16_once(v)

    x, s, t, r, rs, rt = bf(20), bf(6), bf(20), bf(20), bf(6), bf(20)
    xp = np.maximum(_bf16_once(_bf16_once(x * s) + t), 0)
    rp = np.maximum(_bf16_once(_bf16_once(r * rs) + rt), 0)
    once = np.maximum(_bf16_once(rp + xp), 0).astype(np.float32)
    got = np.maximum(_rbf(kernel_prep(r.astype(np.float32), rs, rt)
                          + kernel_prep(x.astype(np.float32), s, t)), 0)
    np.testing.assert_array_equal(got, once)

    def col(v):
        return torch.from_numpy(v.astype(np.float32)).to(BF)[None, :, None,
                                                               None]

    def aff(a, b):
        return (torch.from_numpy(a.astype(np.float32))[None],
                torch.from_numpy(b.astype(np.float32))[None])

    plain = torch.relu(ce.prep(col(r), aff(rs, rt)) + ce.prep(col(x),
                                                               aff(s, t)))
    np.testing.assert_array_equal(_np(plain).reshape(-1), once)
