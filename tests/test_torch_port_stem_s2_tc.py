"""Row 12 on the tensor cores (``csrc/enc_conv.cu``'s ``stem7_tc_kernel<2>``,
``cuda_encoder.stem_conv7_s2``): layout and numerics, on the CPU.

The kernel runs only on the card.  These tests hold what surrounds it,
from the source's own constants (``test_torch_port_stem_tc.stem_constants``
at stride 2): its K order is row 13's (every (ci, dy, dx) once, the pad k
zero); its staged tile, 21 rows of 69 raw columns each stored as an even
and an odd column plane of 35, 42 apart, with the gather table, sends
each k of each output pixel to its input (raw row 2 ly + dy, column 2 lx
+ dx), the 8 lanes of a fragment row to 8 consecutive words, and a pad k
into the zeros past the plane; a model of the 32 shared-memory banks
gives the planes 42 apart fewer conflicts in the fragment gathers than
packed ones; the 8x32 tiles (``stem_geometry``'s ``nb``) cover
each stride-2 output once at odd and small shapes; an emulation of the
kernel's arithmetic (row 13's, at stride 2) stays within ``ENC_TOL`` of
``conv_plain`` with and without sums and, patched into the port's conv1
stage, within the stage tests' tolerance of the JAX package's stride-2
``conv1_stem_layer1`` (its ``_stem7s2_kernel`` and stage kernels in
interpret mode).  Inputs are made with numpy from a seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raftstereo_tpu.ops import pallas_encoder as pe
from raftstereo_tpu_torch.ops import cuda_encoder as ce
from raftstereo_tpu_torch.ops import encoder_stage as es
from test_torch_port_enc_tc import ENC_TOL, _rel_err
from test_torch_port_encoder import STAGE_TOL, _conv, _convs, _nchw, _nhwc
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse
from test_torch_port_stem_tc import (_case, emulate_stem, gather_offset,
                                     k_table, stem_constants)

S = 2
emulate_s2 = functools.partial(emulate_stem, stride=S)


def test_staged_tile_maps_every_tap_to_its_input():
    """The stride-2 tile: 21 rows (8 output rows' windows) of 69 raw
    columns (32 outputs' windows), each row staged as the even columns
    then, 42 slots on, the odd ones, 35 each, the slots between zero.
    For every k of the K order and every output pixel (ly, lx) of the
    tile, the staged value at the pixel's base plus the gather table's
    offset is the raw input at (ci, 2 ly + dy, 2 lx + dx); the 8 lanes g
    of a fragment row read 8 consecutive words; a pad k reads past the
    plane and inside its zeros."""
    c = stem_constants(S)
    th, tw = c["kTileH"], c["kTileW"]
    assert (c["IH"], c["HALF"], c["PS"], c["IW"], c["kZeros"]) == (
        21, 35, 42, 84, 1216)
    ci_n = c["kStemIn"]
    raw = np.arange(1, ci_n * c["IH"] * 2 * c["HALF"] + 1).reshape(
        ci_n, c["IH"], 2 * c["HALF"])            # raw column j of each row
    staged = np.zeros((ci_n, c["IH"], c["IW"]), int)
    for j in range(2 * c["HALF"]):
        staged[:, :, (j % S) * c["PS"] + j // S] = raw[:, :, j]
    plane = staged.size
    flat = np.concatenate([staged.reshape(-1), np.zeros(c["kZeros"], int)])
    ly, lx = np.meshgrid(np.arange(th), np.arange(tw), indexing="ij")
    base = S * ly * c["IW"] + lx  # the kernel's pbase (+ g within lx)
    taps = [t for t in k_table().values() if t is not None]
    assert len(taps) == ci_n * 49
    for tap in taps:
        ci, dy, dx = tap
        q = base + gather_offset(tap, S)
        assert (flat[q] == raw[ci, S * ly + dy, S * lx + dx]).all(), tap
        assert (np.diff(q[:, :16], axis=1) == 1).all()  # lanes g: words
    q = base + gather_offset(None, S)
    assert (q >= plane).all() and (q < plane + c["kZeros"]).all()
    assert not flat[q].any()
    assert S * (tw - 1) + 6 < 2 * c["HALF"] and S * (th - 1) + 6 < c["IH"]


def _bank_wavefronts(offset, iw, stride):
    """Shared-memory wavefronts a fragment gather takes on average (the
    most distinct 4-byte words in one of the 32 banks), over the tile's
    m-tiles (base stride * ly * iw + lx), both pixel rows (g, g + 8), both
    k halves (t, t + 4) and the 19 k-steps; ``offset(tap)`` is the gather
    table (a pad k reads 32 consecutive zeros)."""
    table = k_table()
    loads = waves = 0
    for ly in range(8):
        for lx in (0, 16):
            for half in (0, 8):
                for s in range(19):
                    for k4 in (0, 4):
                        banks = {}
                        for t in range(4):
                            tap = table[(s, t + k4)]
                            o = offset(tap) if tap else 10 ** 6
                            for g in range(8):
                                w = stride * ly * iw + lx + half + g + o
                                banks.setdefault(w % 32, set()).add(w)
                        loads += 1
                        waves += max(len(v) for v in banks.values())
    return waves / loads


def test_spaced_planes_meet_in_fewer_banks():
    """The bank model behind the 42-slot spacing of the stride-2 column
    planes: 1.26 wavefronts a gather, against 2.45 with the planes packed
    35 apart, and row 13's 1.34 at stride 1."""
    c2, c1 = stem_constants(S), stem_constants(1)
    spaced = _bank_wavefronts(lambda tap: gather_offset(tap, S), c2["IW"], S)

    def packed(tap):  # the planes 35 apart, rows of 70
        ci, dy, dx = tap
        return (ci * c2["IH"] + dy) * 70 + (dx % 2) * 35 + dx // 2

    dense = _bank_wavefronts(packed, 70, S)
    s1 = _bank_wavefronts(gather_offset, c1["IW"], 1)
    assert (round(spaced, 2), round(dense, 2), round(s1, 2)) == (
        1.26, 2.45, 1.34)


@pytest.mark.parametrize("h,w", [(26, 4), (17, 73), (42, 140), (38, 90),
                                 (16, 64), (15, 63), (3, 3), (576, 960),
                                 (384, 1248)])
def test_tiles_cover_each_output_once(h, w):
    """``stem_geometry``'s 8x32 tiles over the stride-2 output ((h - 1) // 2
    + 1 rows, alike for columns) cover each output pixel once, and the
    warps' m-tiles each pixel of a tile once."""
    c = stem_constants(S)
    th, tw = c["kTileH"], c["kTileW"]
    ho, wo, nb = ce.stem_geometry(h, w, S)
    assert (ho, wo) == ((h - 1) // 2 + 1, (w - 1) // 2 + 1)
    ty, tx = -(-ho // th), -(-wo // tw)
    assert nb == ty * tx
    assert (ty - 1) * th < ho <= ty * th and (tx - 1) * tw < wo <= tx * tw
    seen = np.zeros((ty * th, tx * tw), int)
    for tile in range(nb):
        oy0, ox0 = (tile // tx) * th, (tile % tx) * tw
        for wm in range(c["kStemWarpsM"]):
            for i in range(c["kStemMT"]):
                mt = wm * c["kStemMT"] + i
                mly, mlx = mt // (tw // 16), (mt % (tw // 16)) * 16
                seen[oy0 + mly, ox0 + mlx + np.arange(16)] += 1
    assert (seen == 1).all()
    # the output pixels the card stores: those inside (ho, wo)
    assert (seen[:ho, :wo] == 1).all()


CASES = [(2, 26, 4, 0), (1, 17, 73, 1), (3, 42, 140, 2), (2, 32, 80, 3)]


@pytest.mark.parametrize("want_stats", [True, False],
                         ids=["sums", "no_sums"])
@pytest.mark.parametrize("b,h,w,seed", CASES)
def test_3xtf32_emulation_within_enc_tol_of_plain(b, h, w, seed, want_stats):
    """The stride-2 kernel's arithmetic within ``ENC_TOL`` of
    ``conv_plain`` at stride 2 (outputs, and sums per output pixel) at
    hostile shapes: odd H and W, an output 2 wide, outputs not a multiple
    of the 8x32 tile."""
    img, wt, bias = _case(b, h, w, seed)
    got = emulate_s2(img, wt, bias, want_stats)
    want = ce.conv_plain(img, wt, bias, S, want_stats=want_stats)
    ho, wo, _ = ce.stem_geometry(h, w, S)
    assert got[0].shape == want[0].shape == (b, 64, ho, wo)
    assert _rel_err(got, want, float(ho * wo)) <= ENC_TOL
    assert (got[1] is None) == (not want_stats)


def test_emulated_stride2_conv1_stage_matches_jax(monkeypatch):
    """The port's stride-2 conv1 + norm1 + layer1 stage with row 12
    replaced by the emulation, at the model's widths (3 -> 64, layer1 at
    64), 2 images of 32x48 (a 16x24 output), against the JAX package's
    ``conv1_stem_layer1`` at stride 2 (its ``_stem7s2_kernel`` and stage
    kernels in interpret mode, the fused stem forced on): within the
    stage tests' tolerance."""
    monkeypatch.setattr(ce, "stem_conv7_s2", emulate_s2)
    rng = np.random.default_rng(19)
    img = rng.normal(size=(2, 32, 48, 3)).astype(np.float32)
    jc1, tc1 = _conv(rng, 7, 3, 64)
    jp, tp = _convs(rng, ("c10", "c11", "c20", "c21"), 3, 64, 64)
    with pe.override_fused_stem(True):
        want = np.asarray(jax.jit(pe.conv1_stem_layer1,
                                  static_argnums=(3, 4))(
            jnp.asarray(img), jc1, jp, jnp.float32, S))
    got = _nhwc(es.conv1_stem_layer1(_nchw(img), tc1, tp, S))
    assert got.shape == want.shape == (2, 16, 24, 64) and want.max() > 0.5
    np.testing.assert_allclose(got, want, **STAGE_TOL)
