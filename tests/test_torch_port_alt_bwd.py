"""Row 4, radial taps (``csrc/alt_corr_bwd.cu``, the VJP of the model's
lookup): the kernel's partition of the work and its summation order, on
the CPU.

The kernel runs only on the card.  These tests hold an emulation of it:
one block per (image row, slice of 128 channels, the source's kSlice),
each building the row's coefficient and window-base tables; df1 as one
fmaf chain per channel over the levels ascending, then the taps
ascending; df2 as one fmaf chain per channel over the row's pixels
ascending; poisoning by NaN coordinates and non-finite cotangents.  The
emulation is held against the plain version (``alt_corr_backward_plain``)
within ``chip_smoke.BACKWARD_TOL``, and, through the pyramid's pooling,
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
    for c0 in range(0, c, cs):  # the slices: each rebuilds the tables
        sl = slice(c0, c0 + cs)
        # tables, one thread per (pixel, level)
        coef = torch.zeros(rows, w1, nlev, d_n)
        base = torch.full((rows, w1, nlev), 2 ** 30, dtype=torch.long)
        bad = torch.zeros(rows, w1, nlev, dtype=torch.bool)
        for lvl, width in enumerate(widths):
            gk = gr[:, :, lvl]
            bad[:, :, lvl] = torch.isnan(xr) | ~torch.isfinite(gk).all(-1)
            xl = xr * (1.0 / float(1 << lvl))
            b0 = torch.floor(xl)
            fr = xl - b0
            lo = b0 - float(radius)
            near = (lo <= float(width - 1)) & (lo + float(k) >= 0.0)
            base[:, :, lvl] = torch.where(near & ~bad[:, :, lvl],
                                          lo.nan_to_num(0.0).long(), 2 ** 30)
            for d in range(d_n):
                v = torch.zeros(rows, w1)
                if d < k:
                    v = gk[..., d] * (1.0 - fr)
                if d > 0:
                    v = v + gk[..., d - 1] * fr
                coef[:, :, lvl, d] = v * scale
        poison = torch.stack([bad[:, :, lvl].any(1) & (widths[lvl] > 0)
                              for lvl in range(nlev)], 1)   # (rows, L)
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
        pix_bad = (bad & (torch.tensor(widths) > 0)).any(-1)
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
        col_bad = poison[:, lvl_of]                       # (rows, W2cat)
        df2[:, :, sl] = torch.where(col_bad[..., None], torch.nan, acc)
    return df1.reshape(f1.shape), df2.reshape(f2cat.shape)


def _inputs(case, seed=3, c=128):
    """(fmap1, fmap2, x, g) of one case, numpy fp32.  ``recipe``: the
    recipe's row width (W1 180, levels 180/90/45/22) and its disparities
    (x = column - 60*U(0, 1)); ``poison``: a NaN coordinate and an
    infinite cotangent; ``outside``: coordinates past every level and
    partly past each edge; ``wide``: a row of 440 pixels, C 256 (two
    slices)."""
    b, h, w = (1, 2, 440) if case == "wide" else (1, 3, 180)
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
    if case == "outside":
        x[0, 0, :4] = [-200.5, w + 300.25, 1e6, -1e6]
        x[0, 1, :3] = [-3.5, w + 1.75, w - 0.5]
    return f1, f2, x, g


def _port(f1, f2, x, g):
    st = build_corr_state(_t(f1), _t(f2), LEVELS)
    return st, _t(x), _t(g)


CASES = ["recipe", "poison", "outside", "wide"]


def _poison_matches(a, w):
    """The kernel's poisoning against a dense-hat reference: NaN exactly
    where the reference is not finite.  (An infinite cotangent's tap gives
    the dense hat +-inf on the two columns it weights and NaN, inf * 0, on
    the level's others; the kernel poisons the whole level with NaN.)"""
    return torch.equal(a.isnan(), ~torch.isfinite(w))


@pytest.mark.parametrize("case", CASES)
def test_emulation_within_tol_of_plain(case):
    """The emulated kernel against ``alt_corr_backward_plain``: NaN where
    plain is not finite (a poisoned pixel's df1 and its level's columns in
    that row) and within ``BACKWARD_TOL`` elsewhere."""
    st, x, g = _port(*_inputs(case))
    got = emulate(st.fmap1, st.f2cat, st.widths, x, g, RADIUS)
    want = cuda_alt.alt_corr_backward_plain(st.fmap1, st.f2cat, st.widths,
                                            x, g, RADIUS)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        assert _poison_matches(a, w)
        ok = torch.isfinite(w)
        scale = max(1.0, float(w[ok].abs().max()))
        err = float((a[ok] - w[ok]).abs().max())
        assert err <= BACKWARD_TOL * scale, err
    assert bool(got[0].isnan().any()) == (case == "poison")
    if case == "poison":
        assert int(want[1][0, 2].isinf().any(-1).sum()) == 2
        # the inf cotangent poisons level 2's 45 columns of row 2 and the
        # pixel's df1; the NaN coordinate every level of row 1
        assert int(got[1][0, 2].isnan().any(-1).sum()) == 45
        assert int(got[1][0, 1].isnan().any(-1).sum()) == st.f2cat.shape[2]


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


@pytest.mark.parametrize("case", ["recipe", "poison", "outside"])
def test_emulation_matches_jax(case):
    """The emulated kernel's gradients, carried to fmap2 through the
    pyramid's pooling, against the JAX ``custom_vjp`` of the Pallas lookup
    in interpret mode: NaN where JAX is not finite, within
    ``BACKWARD_TOL`` of max(1, |JAX|) elsewhere."""
    f1, f2, x, g = _inputs(case)
    want = _vjp_jax("pallas_alt", f1, f2, x, g, LEVELS, RADIUS)
    t2 = _t(f2).requires_grad_()
    st = build_corr_state(_t(f1), t2, LEVELS)
    df1, df2cat = emulate(st.fmap1, st.f2cat.detach(), st.widths, _t(x),
                          _t(g), RADIUS)
    (df2,) = torch.autograd.grad(st.f2cat, t2, df2cat)
    for a, w in zip((df1.numpy(), df2.numpy()), want):
        assert a.shape == w.shape
        # NaN where JAX is not finite (see ``_poison_matches``)
        np.testing.assert_array_equal(np.isnan(a), ~np.isfinite(w))
        ok = np.isfinite(w)
        scale = max(1.0, float(np.abs(w[ok]).max()))
        np.testing.assert_allclose(a[ok], w[ok], rtol=0,
                                   atol=BACKWARD_TOL * scale)
