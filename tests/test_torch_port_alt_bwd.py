"""Row 4, radial taps (``csrc/alt_corr_bwd.cu``, the VJP of the model's
lookup): the kernel's partition of the work and its summation order, on
the CPU.

The kernel runs only on the card.  These tests hold an emulation of it:
one block per (image row, slice of 128 channels, the source's kSlice),
each building the row's coefficient and window-base tables; df1 as one
fmaf chain per channel over the levels ascending, then the taps
ascending; df2 as one fmaf chain per channel over the row's pixels
ascending; the non-finite values of NaN coordinates and of NaN and
infinite cotangents, as the dense hat gives them.  The emulation is held
against the plain version (``alt_corr_backward_plain``) within
``chip_smoke.BACKWARD_TOL``, with NaN and +-inf exactly where it has
them, and, through the pyramid's pooling,
against the JAX package's ``custom_vjp`` of the Pallas lookup (its
``_alt_pyr_bwd_kernel`` in interpret mode).  Inputs are made with numpy
from a seed.
"""

import re
import sys

import numpy as np
import pytest
import torch

from raftstereo_tpu_torch.ops import _build, cuda_alt
from raftstereo_tpu_torch.ops.corr import build_corr_state
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse
from test_torch_port_ops import _t, _vjp_jax

# chip_smoke.py's BACKWARD_TOL: each gradient within 1e-4 x max(1,
# |plain|) of the plain version (sums of ~40-200 fp32 products of O(1)
# terms, in another order).
BACKWARD_TOL = 1e-4
LEVELS, RADIUS = 4, 4


# ---------------------------------------------------------------- slices

def _source():
    return _build.sources()["alt_corr_bwd"].read_text()


def slice_width():
    """Channels per block, the source's kSlice = 32 lanes x kVec."""
    src = _source()
    assert re.search(r"kSlice = 32 \* kVec;", src)
    return 32 * int(re.search(r"kVec = (\d+);", src).group(1))


def test_slices_divide_every_channel_width():
    """128-channel slices: every C the kernel takes (a multiple of 128 up
    to 512) is a whole number of slices, each lane one float4."""
    assert slice_width() == 128
    assert all(c % slice_width() == 0 for c in (128, 256, 384, 512))


# ------------------------------------------------------------- emulation

def _fma(a, b, c):
    """fmaf in fp32 (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def emulate(f1, f2cat, widths, x, g, radius):
    """``alt_corr_backward`` as the kernel computes it: f1 (B, H, W1, C),
    f2cat (B, H, W2cat, C), x (B, H, W1), g (B, H, W1, L*K) -> (df1,
    df2cat), one (row, channel slice) block at a time, all rows at once."""
    b, h, w1, c = f1.shape
    w2cat = f2cat.shape[2]
    nlev, k = len(widths), 2 * radius + 1
    d_n = k + 1
    offs = [sum(widths[:i]) for i in range(nlev)]
    cs = slice_width()
    f1r, f2r = f1.reshape(-1, w1, c), f2cat.reshape(-1, w2cat, c)
    xr, gr = x.reshape(-1, w1), g.reshape(-1, w1, nlev, k)
    rows = f1r.shape[0]
    df1 = torch.empty_like(f1r)
    df2 = torch.empty_like(f2r)
    scale = torch.tensor(1.0 / float(c) ** 0.5)
    far = 2 ** 29
    for c0 in range(0, c, cs):  # the slices: each rebuilds the tables
        sl = slice(c0, c0 + cs)
        # tables, one thread per (pixel, level)
        coef = torch.zeros(rows, w1, nlev, d_n)
        base = torch.full((rows, w1, nlev), far, dtype=torch.long)
        df1_nan = torch.zeros(rows, w1, nlev, dtype=torch.bool)
        # columns [keep_lo, keep_hi] of each level stay finite in the row
        keep_lo = torch.full((rows, nlev), -2 ** 31, dtype=torch.long)
        keep_hi = torch.full((rows, nlev), 2 ** 31 - 1, dtype=torch.long)
        for lvl, width in enumerate(widths):
            gk = gr[:, :, lvl]
            nan_in = torch.isnan(xr) | torch.isnan(gk).any(-1)
            inf_k = torch.isinf(gk)                      # (rows, W1, K)
            inf_any = inf_k.any(-1)
            xl = xr * (1.0 / float(1 << lvl))
            b0 = torch.floor(xl)
            fr = xl - b0
            lo = b0 - float(radius)
            near = (lo <= float(width - 1)) & (lo + float(k) >= 0.0)
            has_b = near & ~nan_in
            b = torch.where(has_b, lo.nan_to_num(0.0), 0.0).long()
            whole = nan_in | (inf_any & ~has_b)   # every column NaN
            part = inf_any & has_b                # the window's may not be
            base[:, :, lvl] = torch.where(has_b & ~whole, b, far)
            df1_nan[:, :, lvl] = whole | (part & ((b > 0)
                                                  | (b + d_n - 1 < width - 1)))
            big = 2 ** 31 - 1
            keep_lo[:, lvl] = torch.where(
                whole.any(1), big,
                torch.where(part, b, -big - 1).amax(1))
            keep_hi[:, lvl] = torch.where(part, b + d_n - 1, big).amin(1)
            for d in range(d_n):
                v = torch.zeros(rows, w1)
                if d < k:
                    v = gk[..., d] * (1.0 - fr)
                if d > 0:
                    v = v + gk[..., d - 1] * fr
                # an infinite tap that does not reach column b+d: inf * 0
                reach = torch.zeros(k, dtype=torch.bool)
                reach[max(d - 1, 0):d + 1] = True
                elsewhere = (inf_k & ~reach).any(-1)
                coef[:, :, lvl, d] = torch.where(elsewhere, torch.nan,
                                                 v * scale)
        # df1: levels ascending, then taps ascending
        acc = torch.zeros(rows, w1, cs)
        for lvl, width in enumerate(widths):
            for d in range(d_n):
                j = base[:, :, lvl] + d
                ok = (j >= 0) & (j < width)
                col = offs[lvl] + j.clamp(0, max(width - 1, 0))
                v = torch.gather(f2r[:, :, sl], 1,
                                 col[..., None].expand(-1, -1, cs))
                acc = torch.where(ok[..., None],
                                  _fma(coef[:, :, lvl, d, None], v, acc), acc)
        pix_bad = (df1_nan & (torch.tensor(widths) > 0)).any(-1)
        df1[:, :, sl] = torch.where(pix_bad[..., None], torch.nan, acc)
        # df2: the row's pixels ascending
        acc = torch.zeros(rows, w2cat, cs)
        rix = torch.arange(rows)[:, None].expand(-1, d_n)
        for i in range(w1):
            for lvl, width in enumerate(widths):
                j = base[:, i, lvl, None] + torch.arange(d_n)  # (rows, D)
                ok = (j >= 0) & (j < width)   # distinct columns where ok
                r, col = rix[ok], offs[lvl] + j[ok]
                acc[r, col] = _fma(coef[:, i, lvl][ok][:, None],
                                   f1r[r, i, sl], acc[r, col])
        lvl_of = torch.repeat_interleave(torch.arange(nlev),
                                         torch.tensor(widths))
        jl = torch.arange(w2cat) - torch.tensor(offs)[lvl_of]
        col_bad = ((jl < keep_lo[:, lvl_of])
                   | (jl > keep_hi[:, lvl_of]))          # (rows, W2cat)
        df2[:, :, sl] = torch.where(col_bad[..., None], torch.nan, acc)
    return df1.reshape(f1.shape), df2.reshape(f2cat.shape)


def _inputs(case, seed=3, c=128):
    """(fmap1, fmap2, x, g) of one case, numpy fp32.  ``recipe``: the
    recipe's row width (W1 180, levels 180/90/45/22) and its disparities
    (x = column - 60*U(0, 1)); ``poison``: a NaN coordinate and an
    infinite cotangent; ``outside``: coordinates past every level and
    partly past each edge; ``wide``: a row of 440 pixels, C 256 (two
    slices); ``inf_mix``: rows of 12 (levels 12/6/3/1) with an infinite
    cotangent whose window covers its whole level, two infinite pixels
    whose windows overlap, one at a tap on an integer coordinate, a -inf
    one and a NaN cotangent."""
    b, h, w = {"wide": (1, 2, 440), "inf_mix": (1, 3, 12)}.get(case,
                                                              (1, 3, 180))
    c = 256 if case == "wide" else c
    rng = np.random.default_rng(seed)
    f1 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    f2 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    x = (np.arange(w) - 60.0 * rng.uniform(size=(b, h, w))).astype(np.float32)
    g = rng.normal(size=(b, h, w, LEVELS * (2 * RADIUS + 1))).astype(
        np.float32)
    if case == "poison":
        x[0, 1, 17] = np.nan
        # level 2 of row 2, at a pixel whose tap 3 weights two columns
        x[0, 2, 100] = 70.5
        g[0, 2, 100, 2 * (2 * RADIUS + 1) + 3] = np.inf
    if case == "inf_mix":
        kk = 2 * RADIUS + 1
        x[0] = np.arange(w) - 0.75
        x[0, 0, 2] = 4.0      # level 3 (1 wide): x_l = 0.5
        g[0, 0, 2, 3 * kk + RADIUS] = np.inf
        x[0, 1, 3:5] = [3.25, 4.25]  # both taps weight columns 3 and 4
        g[0, 1, 3, RADIUS] = np.inf
        g[0, 1, 4, RADIUS - 1] = np.inf
        x[0, 2, 6] = 6.0      # tap 2 on column 4 (weight 1), column 5: 0
        g[0, 2, 6, 2] = np.inf
        g[0, 2, 9, kk + 5] = -np.inf
        g[0, 2, 10, 2 * kk] = np.nan
    if case == "outside":
        x[0, 0, :4] = [-200.5, w + 300.25, 1e6, -1e6]
        x[0, 1, :3] = [-3.5, w + 1.75, w - 0.5]
    return f1, f2, x, g


def _port(f1, f2, x, g):
    st = build_corr_state(_t(f1), _t(f2), LEVELS)
    return st, _t(x), _t(g)


CASES = ["recipe", "poison", "outside", "wide", "inf_mix"]


def _nonfinite_matches(a, w):
    """The kernel's non-finite values against a dense-hat reference: NaN
    exactly where the reference is NaN, and the same +-inf where it is
    infinite (an infinite cotangent's tap gives the two columns it weights
    +-inf and the level's others NaN, inf * 0)."""
    inf = w.isinf()
    return (torch.equal(a.isnan(), w.isnan()) and torch.equal(a.isinf(), inf)
            and torch.equal(a[inf], w[inf]))


@pytest.mark.parametrize("case", CASES)
def test_emulation_within_tol_of_plain(case):
    """The emulated kernel against ``alt_corr_backward_plain``: NaN and
    +-inf exactly where plain has them (a NaN pixel's df1 and its row's
    columns; an infinite cotangent's pixel df1 and its level's columns in
    that row, two of them +-inf) and within ``BACKWARD_TOL`` elsewhere."""
    st, x, g = _port(*_inputs(case))
    got = emulate(st.fmap1, st.f2cat, st.widths, x, g, RADIUS)
    want = cuda_alt.alt_corr_backward_plain(st.fmap1, st.f2cat, st.widths,
                                            x, g, RADIUS)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        assert _nonfinite_matches(a, w)
        ok = torch.isfinite(w)
        scale = max(1.0, float(w[ok].abs().max()))
        err = float((a[ok] - w[ok]).abs().max())
        assert err <= BACKWARD_TOL * scale, err
    assert bool(got[0].isnan().any()) == (case in ("poison", "inf_mix"))
    if case == "poison":
        assert int(want[1][0, 2].isinf().any(-1).sum()) == 2
        # the inf cotangent gives +-inf on the two columns its tap weights,
        # NaN on level 2's 43 others in row 2 and on the pixel's df1; the
        # NaN coordinate poisons every level of row 1
        assert int(got[1][0, 2].isinf().any(-1).sum()) == 2
        assert int(got[1][0, 2].isnan().any(-1).sum()) == 43
        assert bool(got[0][0, 2, 100].isnan().all())
        assert int(got[1][0, 1].isnan().any(-1).sum()) == st.f2cat.shape[2]
    if case == "inf_mix":
        df1, df2 = got
        assert bool(df1[0, 0, 2].isinf().all())   # its level is 1 wide
        # both windows' +inf taps reach columns 3 and 4 (inf - inf where
        # the two pixels' fmap1 signs differ); the level's others are NaN
        assert bool(df2[0, 1, 3:5].isinf().any(-1).all())
        assert int(df2[0, 1, :12].isnan().all(-1).sum()) == 10
        assert bool(df2[0, 2, 4].isinf().all())
        assert bool(df2[0, 2, 5].isnan().all())


def test_slice_width_leaves_every_bit(monkeypatch):
    """128-channel and 32-channel slices give equal bits: the partition
    changes no summation order (the first form of the kernel took all of
    C per block)."""
    st, x, g = _port(*_inputs("recipe"))
    wide = emulate(st.fmap1, st.f2cat, st.widths, x, g, RADIUS)
    monkeypatch.setattr(sys.modules[__name__], "slice_width", lambda: 32)
    narrow = emulate(st.fmap1, st.f2cat, st.widths, x, g, RADIUS)
    for a, b in zip(wide, narrow):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["recipe", "poison", "outside", "inf_mix"])
def test_emulation_matches_jax(case):
    """The emulated kernel's gradients, carried to fmap2 through the
    pyramid's pooling, against the JAX ``custom_vjp`` of the Pallas lookup
    in interpret mode: NaN and +-inf exactly where JAX has them, within
    ``BACKWARD_TOL`` of max(1, |JAX|) elsewhere.  One place differs, by
    the TPU kernel's layout: an infinite tap that weights every column of
    a 1-wide level gives its pixel's df1 +-inf in the plain version and
    the kernel, and NaN in JAX, whose hat row also spans the level's lane
    padding (inf * 0 there, times zero-padded fmap2 rows)."""
    f1, f2, x, g = _inputs(case)
    want = [np.array(w) for w in _vjp_jax("pallas_alt", f1, f2, x, g,
                                          LEVELS, RADIUS)]
    if case == "inf_mix":
        assert np.isnan(want[0][0, 0, 2]).all()
        pst, px, pg = _port(f1, f2, x, g)
        plain_df1 = cuda_alt.alt_corr_backward_plain(
            pst.fmap1, pst.f2cat, pst.widths, px, pg, RADIUS)[0]
        assert np.isinf(plain_df1[0, 0, 2].numpy()).all()
        want[0][0, 0, 2] = plain_df1[0, 0, 2].numpy()
    t2 = _t(f2).requires_grad_()
    st = build_corr_state(_t(f1), t2, LEVELS)
    df1, df2cat = emulate(st.fmap1, st.f2cat.detach(), st.widths, _t(x),
                          _t(g), RADIUS)
    (df2,) = torch.autograd.grad(st.f2cat, t2, df2cat)
    for a, w in zip((df1.numpy(), df2.numpy()), want):
        assert a.shape == w.shape
        # NaN and +-inf exactly where JAX has them
        assert _nonfinite_matches(torch.from_numpy(a), torch.from_numpy(w))
        ok = np.isfinite(w)
        scale = max(1.0, float(np.abs(w[ok]).max()))
        np.testing.assert_allclose(a[ok], w[ok], rtol=0,
                                   atol=BACKWARD_TOL * scale)
