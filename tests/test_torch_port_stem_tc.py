"""Row 13 on the tensor cores (``csrc/enc_conv.cu``'s stride-1 stem,
``cuda_encoder.stem_conv7``): layout and numerics, on the CPU.

The kernel runs only on the card.  These tests hold what surrounds it,
from the source's own constants: its K order (k = ci * 49 + dy * 7 + dx,
the weights' own order, padded from 147 to 152: 19 k-steps of 8) hits
every (ci, dy, dx) of the 7x7 3 -> 64 weights once, its pad k carry zero
weights, and its gather table sends each k to its input; its 8x32 output
tiles (the wrapper's ``nb``) cover each output once and its warps'
m-tiles each pixel of a tile once; and an emulation of its arithmetic
(the raw image zero-padded and split into TF32 hi and lo once; per group
of 4 k-steps a fresh float64 sum of the 3xTF32 products, rounded to fp32
and added to the running fp32 total in order; + bias; the output sums in
the kernel's order) stays within ``ENC_TOL`` of ``conv_plain``
and, patched into the port's conv1 stage, of the JAX package's
``conv1_stem_layer1`` (its ``_stem7_kernel`` in interpret mode).  A
single TF32 pass is emulated beside, to show why 3xTF32 is kept.  Inputs
are made with numpy from a seed.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from raftstereo_tpu.ops import pallas_encoder as pe
from raftstereo_tpu_torch.ops import _build
from raftstereo_tpu_torch.ops import cuda_encoder as ce
from raftstereo_tpu_torch.ops import encoder_stage as es
from raftstereo_tpu_torch.ops.cuda_gru import tf32_round
from test_torch_port_enc_tc import ENC_TOL, _kernel_sums, _rel_err
from test_torch_port_encoder import STAGE_TOL, _conv, _convs, _nchw, _nhwc
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse


@functools.lru_cache(maxsize=None)
def stem_constants(stride=1):
    """The stem kernel's constants, from ``enc_conv.cu``, and its staged
    tile at ``stride`` (``StemTile<S>``): IH rows of IW values, each row
    S column planes of HALF values PS apart (raw column j at (j % S) * PS
    + j // S), then kZeros zeros."""
    src = " ".join(_build.sources()["enc_conv"].read_text().split())

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)[,;]", src).group(1))

    names = ("kStemIn", "kStemOut", "kStemKS", "kStemWarpsM", "kStemWarpsN",
             "kStemMT", "kStemNT", "kStemGroup", "kTileH", "kTileW")
    got = {n: const(n) for n in names}
    # the K order, the staged tile, the gather table and a pixel's base, as
    # the kernel writes them
    for text in ("kStemK = kStemIn * kStemKS * kStemKS",
                 "kStemKSteps = (kStemK + 7) / 8",
                 "split(__ldg(a.w + n * kStemK + k), hi, lo)",
                 "kIH = (kStemTH - 1) * S + kStemKS",
                 "kRaw = (kStemTW - 1) * S + kStemKS",
                 "kHalf = (kRaw + S - 1) / S",
                 "kPS = S == 1 ? kHalf : 42", "kIW = S * kPS",
                 "kPlane = kStemIn * kIH * kIW",
                 "kZeros = ((kStemTH - 1) * S * kIW + kStemTW + 31) / 32 * 32",
                 "(ci * G::kIH + dy) * G::kIW + (dx % S) * G::kPS + dx / S",
                 "c = q % G::kPS", "c * S + q / G::kPS", "c < G::kHalf &&",
                 "(mt / (kStemTW / 16)) * S * G::kIW + "
                 "(mt % (kStemTW / 16)) * 16 + g",
                 "kStemTH = kTileH, kStemTW = kTileW"):
        assert text in src, text
    s, th, tw, ks = stride, got["kTileH"], got["kTileW"], got["kStemKS"]
    got["S"] = s
    got["IH"] = (th - 1) * s + ks
    got["HALF"] = -(-((tw - 1) * s + ks) // s)
    got["PS"] = got["HALF"] if s == 1 else 42
    got["IW"] = s * got["PS"]
    got["kZeros"] = ((th - 1) * s * got["IW"] + tw + 31) // 32 * 32
    return got


def k_table():
    """(k-step, k) -> (ci, dy, dx) or None (a pad k), in the kernel's K
    order: k-step s, slot k holds K index 8s + k = ci * 49 + dy * 7 + dx,
    the pad past 147."""
    c = stem_constants()
    taps = c["kStemKS"] ** 2
    table = {}
    for kk in range(-(-c["kStemIn"] * taps // 8) * 8):
        ci, tap = divmod(kk, taps)
        table[divmod(kk, 8)] = ((ci, tap // c["kStemKS"], tap % c["kStemKS"])
                                if kk < c["kStemIn"] * taps else None)
    return table


def gather_offset(tap, stride=1):
    """The kernel's gather table entry of a k: its (ci, dy, dx)'s plane
    offset, (ci * IH + dy) * IW + (dx % S) * PS + dx // S; a pad k's, the
    plane's size (the zeros past it)."""
    c = stem_constants(stride)
    if tap is None:
        return c["kStemIn"] * c["IH"] * c["IW"]
    ci, dy, dx = tap
    return ((ci * c["IH"] + dy) * c["IW"] + (dx % stride) * c["PS"]
            + dx // stride)


def stem_pack(weight):
    """The weights as the kernel lays them out in shared memory, before
    the TF32 split: (64 outputs, k-steps, 8 k), zero at the pad."""
    table = k_table()
    steps = 1 + max(s for s, _ in table)
    pack = torch.zeros(weight.shape[0], steps, 8)
    for (s, k), tap in table.items():
        if tap is not None:
            ci, dy, dx = tap
            pack[:, s, k] = weight[:, ci, dy, dx]
    return pack


def test_k_order_hits_every_tap_once_and_pads_with_zeros():
    """19 k-steps of 8: every (ci, dy, dx) of the 7x7x3 kernel once, the
    last step's last 5 k the pad, whose packed weights are all zero; the
    gather table sends each k to its own input value of a raw tile (k's
    offset plus a pixel's base is the haloed input at (ci, ly + dy, lx +
    dx)), and a pad k from any pixel of the tile into the zeros."""
    c = stem_constants()
    assert (c["kStemIn"], c["kStemOut"], c["kStemKS"]) == (3, 64, 7)
    assert ce.STEM_WEIGHT == (c["kStemOut"], c["kStemIn"], c["kStemKS"],
                              c["kStemKS"])
    table = k_table()
    taps = [t for t in table.values() if t is not None]
    assert len(table) == 19 * 8 and len(taps) == 3 * 49
    assert sorted(taps) == [(ci, dy, dx) for ci in range(3)
                            for dy in range(7) for dx in range(7)]
    assert [k for k, t in table.items() if t is None] == [
        (18, k) for k in range(3, 8)]
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 3, 7, 7)).astype(np.float32))
    pack = stem_pack(w)
    assert not pack.reshape(64, -1)[:, 147:].any()
    assert pack.reshape(64, -1)[:, :147].all()
    raw = np.arange(c["kStemIn"] * c["IH"] * c["IW"]).reshape(
        c["kStemIn"], c["IH"], c["IW"])
    plane = raw.size
    ly, lx = np.meshgrid(np.arange(c["kTileH"]), np.arange(c["kTileW"]),
                         indexing="ij")
    for tap in taps:
        ci, dy, dx = tap
        q = ly * c["IW"] + lx + gather_offset(tap)
        assert (raw.reshape(-1)[q] == raw[ci, ly + dy, lx + dx]).all()
    last = (c["kTileH"] - 1) * c["IW"] + c["kTileW"] - 1
    assert plane <= gather_offset(None) and (gather_offset(None) + last
                                             < plane + c["kZeros"])


@pytest.mark.parametrize("h,w", [(13, 2), (9, 37), (21, 70), (19, 45),
                                 (8, 32), (7, 31), (576, 960), (384, 1248)])
def test_tiles_cover_each_output_once(h, w):
    """The wrapper's ``nb`` tiles of 8x32 (the source's kTileH x kTileW)
    cover each output pixel once; within a tile the warps' m-tiles (16
    pixels of one output row) and their lanes' fragment rows (g, g + 8)
    cover each of the 256 pixels once."""
    c = stem_constants()
    th, tw = c["kTileH"], c["kTileW"]
    assert (th, tw) == (ce._TILE_H, ce._TILE_W)
    assert c["kStemWarpsN"] * c["kStemNT"] * 8 == c["kStemOut"]
    ty, tx = -(-h // th), -(-w // tw)
    assert (ty - 1) * th < h <= ty * th and (tx - 1) * tw < w <= tx * tw
    seen = np.zeros((ty * th, tx * tw), int)
    for tyi in range(ty):
        for txi in range(tx):
            for wm in range(c["kStemWarpsM"]):
                for i in range(c["kStemMT"]):
                    mt = wm * c["kStemMT"] + i
                    ly, lx = mt // (tw // 16), (mt % (tw // 16)) * 16
                    cols = txi * tw + lx + np.arange(16)  # g + 8 * half
                    seen[tyi * th + ly, cols] += 1
    assert (seen == 1).all()


def emulate_stem(img, weight, bias, want_stats=True, passes="3xtf32",
                 stride=1):
    """The kernel's arithmetic at ``stride``: ``(y, sums or None)`` as
    ``stem_conv7`` (``stem_conv7_s2``) returns them.  ``passes`` "tf32"
    keeps a_hi*b_hi alone."""
    b, _, hi, wi = img.shape
    h, w = (hi - 1) // stride + 1, (wi - 1) // stride + 1  # the output
    x = F.pad(img, (3, 3, 3, 3))  # zero outside the raw image
    a_hi = tf32_round(x)
    a_lo = tf32_round(x - a_hi)
    a_hi, a_lo = a_hi.double(), a_lo.double()
    pack = stem_pack(weight)
    p_hi = tf32_round(pack)
    p_lo = tf32_round(pack - p_hi)
    p_hi, p_lo = p_hi.double(), p_lo.double()
    table = k_table()
    c = stem_constants()
    steps = 1 + max(s for s, _ in table)
    acc = torch.zeros(b, weight.shape[0], h, w)
    for s0 in range(0, steps, c["kStemGroup"]):
        fresh = torch.zeros(b, weight.shape[0], h, w, dtype=torch.float64)
        for (s, k), tap in table.items():
            if tap is None or not s0 <= s < s0 + c["kStemGroup"]:
                continue
            ci, dy, dx = tap
            wh, wl = p_hi[:, s, k], p_lo[:, s, k]
            rows = slice(dy, dy + stride * (h - 1) + 1, stride)
            cols = slice(dx, dx + stride * (w - 1) + 1, stride)
            xh = a_hi[:, ci, rows, cols]
            xl = a_lo[:, ci, rows, cols]
            if passes == "3xtf32":
                fresh += torch.einsum("byx,o->boyx", xl, wh)
                fresh += torch.einsum("byx,o->boyx", xh, wl)
            fresh += torch.einsum("byx,o->boyx", xh, wh)
        acc = acc + fresh.float()
    y = acc + bias[:, None, None]
    if not want_stats:
        return y, None
    # the stats order: that of enc_conv_tc.cu's "stage_conv" instance (the
    # same 8x32 tile and fragment layout), over the stem's pixel warps
    assert ce.TC_INSTANCES["stage_conv"][2] == c["kTileW"]
    return y, _kernel_sums(y, "stage_conv", c["kStemWarpsM"])


def _case(b, h, w, seed):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(np.tanh(rng.normal(size=(b, 3, h, w)) * 2)
                           .astype(np.float32))
    wt = torch.from_numpy((rng.normal(size=(64, 3, 7, 7))
                           * (2.0 / 147) ** 0.5).astype(np.float32))
    bias = torch.from_numpy((rng.normal(size=64) * 0.1).astype(np.float32))
    return img, wt, bias


CASES = [(2, 13, 2, 0), (1, 9, 37, 1), (3, 21, 70, 2), (2, 16, 40, 3)]


@pytest.mark.parametrize("want_stats", [True, False],
                         ids=["sums", "no_sums"])
@pytest.mark.parametrize("b,h,w,seed", CASES)
def test_3xtf32_emulation_within_enc_tol_of_plain(b, h, w, seed, want_stats):
    """The kernel's arithmetic within ``ENC_TOL`` of ``conv_plain``
    (outputs, and sums per pixel) at the card tests' hostile shapes: H not
    a multiple of the 8-row tile, W = 2 and W not a multiple of 32."""
    img, wt, bias = _case(b, h, w, seed)
    got = emulate_stem(img, wt, bias, want_stats)
    want = ce.conv_plain(img, wt, bias, 1, want_stats=want_stats)
    assert _rel_err(got, want, float(h * w)) <= ENC_TOL
    assert (got[1] is None) == (not want_stats)


@pytest.mark.parametrize("b,h,w,seed", CASES[2:])
def test_single_tf32_pass_is_reported_beside(b, h, w, seed):
    """A single TF32 pass (a_hi*b_hi) at the same inputs: its error is
    reported beside the 3xTF32 one and is several times larger; the
    kernel takes three passes."""
    img, wt, bias = _case(b, h, w, seed)
    want = ce.conv_plain(img, wt, bias, 1)
    e3 = _rel_err(emulate_stem(img, wt, bias), want, float(h * w))
    e1 = _rel_err(emulate_stem(img, wt, bias, passes="tf32"), want,
                  float(h * w))
    print(f"stem {b}x{h}x{w}: 3xTF32 {e3:.2e}, single TF32 {e1:.2e} "
          f"(tol {ENC_TOL})")
    assert e1 > 10 * e3 and e1 > ENC_TOL


def test_emulated_conv1_stage_matches_jax(monkeypatch):
    """The port's conv1 + norm1 + layer1 stage with row 13 replaced by the
    emulation, at the model's widths (3 -> 64, layer1 at 64), 2 images of
    16x24, against the JAX package's ``conv1_stem_layer1`` (its
    ``_stem7_kernel`` and stage kernels in interpret mode): within the
    stage tests' tolerance."""
    monkeypatch.setattr(ce, "stem_conv7", emulate_stem)
    rng = np.random.default_rng(17)
    img = rng.normal(size=(2, 16, 24, 3)).astype(np.float32)
    jc1, tc1 = _conv(rng, 7, 3, 64)
    jp, tp = _convs(rng, ("c10", "c11", "c20", "c21"), 3, 64, 64)
    want = np.asarray(jax.jit(pe.conv1_stem_layer1, static_argnums=(3, 4))(
        jnp.asarray(img), jc1, jp, jnp.float32, 1))
    got = _nhwc(es.conv1_stem_layer1(_nchw(img), tc1, tp, 1))
    assert got.shape == want.shape and want.max() > 0.5
    np.testing.assert_allclose(got, want, **STAGE_TOL)
