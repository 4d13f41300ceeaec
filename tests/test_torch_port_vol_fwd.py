"""Row 5 (``csrc/corr_vol.cu``, the precomputed-volume lookup): the
kernel's windowed form, emulated on the CPU, bit for bit.

The kernel runs only on the card.  A thread owns one (pixel, level) item:
it reads the level's window, the columns [floor(t_0), floor(t_{K-1}) + 1]
that lie in the level, into registers, and each tap takes its two
columns from the window by its own floor, floor(t_k) - floor(t_0) being
k - 1, k or k + 1.  A window that misses the level or reaches 2^24, a tap
whose floor sits elsewhere, and every tap at a radius above the source's
``kMaxWindowRadius`` take the per-tap form: each tap's two columns read
where they lie in the level, 0 elsewhere.  These tests build that output
in torch, in the kernel's arithmetic, with the window's unread entries
set to NaN (so a use of one shows), and hold it bitwise (int32 views,
NaN where plain has NaN) against the plain version
``cuda_vol.vol_lookup_plain`` on hostile inputs, and against the JAX
package's ``pallas_lookup_pyramid_flat`` (its ``_lookup_kernel`` in
interpret mode, lane-padded levels) within 1e-6, NaN matched.  Inputs are
made with numpy from a seed.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raftstereo_tpu.ops import pallas_corr as jpc
from raftstereo_tpu_torch.ops import _build, cuda_vol
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse


def geometry():
    """(the largest windowed radius, the window's extra columns over K),
    from the source."""
    src = _build.source_text("corr_vol")
    radius = int(re.search(r"constexpr int kMaxWindowRadius = (\d+);",
                           src).group(1))
    extra = int(re.search(r"constexpr int KW = KC \+ (\d+);", src).group(1))
    return radius, extra


def emulate(vcat, widths, x, radius, stats=None):
    """``vol_lookup`` as the kernel computes it: vcat (B, H, W1, sum(w)),
    x (B, H, W1) -> (B, H, W1, L*K).  ``stats`` (a dict) gathers how many
    items took a window of each width and how many taps sat one column
    past or before their place in it."""
    max_r, extra = geometry()
    k_n = 2 * radius + 1
    kw = k_n + extra
    nan = torch.tensor(float("nan"))
    zero = torch.zeros(())
    cols, off = [], 0
    for lvl, w in enumerate(widths):
        vl = vcat[..., off:off + w]
        off += w
        xl = x * (1.0 / 2 ** lvl)
        t = cuda_vol.level_taps(x, lvl, radius)           # (..., K)
        last = float(w - 1)
        f0 = torch.floor(t[..., 0])
        fe = torch.floor(t[..., -1]) + 1.0
        have = ((w > 0) & (f0 >= 1 - kw) & (f0 <= last)
                & (fe < 2.0 ** 24))                       # False for NaN
        have &= radius <= max_r
        # the window: column j at f0 + j, NaN where not read
        j = torch.where(have, f0, 0.0)[..., None] + torch.arange(kw)
        read = (have[..., None] & (j >= 0) & (j <= last)
                  & (j <= torch.where(have, fe, 0.0)[..., None]))
        gather = torch.where(read, j, 0.0).long()
        win = (torch.where(read, torch.gather(vl, -1, gather), nan)
                if w > 0 else torch.full(j.shape, float("nan")))
        out = []
        for k in range(k_n):
            tk = t[..., k]
            fa = torch.floor(tk)
            fb = fa + 1.0
            ina = (fa >= 0) & (fa <= last)
            inb = (fb >= 0) & (fb <= last)
            dk = torch.where(have, fa - f0, 0.0)
            near = have & (dk >= k - 1) & (dk <= k + 1)   # the three pairs
            d = torch.where(near, dk, 0.0).long()
            wa = torch.gather(win, -1, d[..., None])[..., 0]
            wb = torch.gather(win, -1, d[..., None] + 1)[..., 0]
            if w > 0:   # the per-tap form: the columns where they lie
                ga = torch.gather(vl, -1, torch.where(ina, fa, 0.0).long()
                                  [..., None])[..., 0]
                gb = torch.gather(vl, -1, torch.where(inb, fb, 0.0).long()
                                  [..., None])[..., 0]
            else:
                ga = gb = torch.zeros_like(tk)
            va = torch.where(near, wa, torch.where(ina, ga, zero))
            vb = torch.where(near, wb, torch.where(inb, gb, zero))
            p0 = torch.where(ina, va * (1.0 - (fa - tk).abs()), zero)
            p1 = torch.where(inb, vb * (1.0 - (fb - tk).abs()), zero)
            v = p0 + p1
            v = torch.where(torch.isnan(xl), nan, v)
            out.append(v if w > 0 else torch.zeros_like(v))
            if stats is not None:
                dk = dk[have]
                for key, n in (("late", (dk == k + 1).sum()),
                               ("early", (dk == k - 1).sum()),
                               ("elsewhere", (~near & have).sum())):
                    stats[key] = stats.get(key, 0) + int(n)
        if stats is not None:
            span = (fe - f0)[have].long()
            for s in span.unique().tolist():
                stats[f"cols{s + 1}"] = (stats.get(f"cols{s + 1}", 0)
                                         + int((span == s).sum()))
            stats["per_tap"] = stats.get("per_tap", 0) + int(
                (~have & ~torch.isnan(xl) & (w > 0)).sum())
        cols.append(torch.stack(out, -1))
    return torch.cat(cols, -1)


def _int_bits(a, b):
    ok = ~a.isnan()
    return (torch.equal(ok, ~b.isnan())
            and torch.equal(a[ok].view(torch.int32), b[ok].view(torch.int32)))


SPECIALS = [np.nan, np.inf, -np.inf, 1e30, -1e30, 127.99999, 0.99999994,
            63.99999, 2.0 ** 24 + 2, -200.5, 364.25, 4.5, -5.0000001,
            31.999998, -0.0, 2.0 ** 23 - 0.5]

# (widths, radius, seed): W1 = 64 pixels a row, 2 x 3 rows.
CASES = {
    "recipe_levels": ((64, 32, 16, 8), 4, 0),
    "serving_widths": ((240, 120, 60, 30), 4, 1),
    "zero_width_level": ((64, 32, 0, 8), 2, 2),
    "radius0": ((64, 32), 0, 3),
    "radius1": ((64, 32, 16), 1, 4),
    "radius3_8_levels": ((64, 32, 16, 8, 4, 2, 1, 0), 3, 5),
    "radius8_per_tap": ((64, 32, 16, 8, 4, 2, 1, 0), 8, 6),
    "one_level_1_wide": ((1,), 4, 7),
}


def _case(name):
    widths, radius, seed = CASES[name]
    rng = np.random.default_rng(seed)
    b, h, w1 = 2, 3, 64
    x = (np.arange(w1) - rng.uniform(-8, 40, (b, h, w1))).astype(np.float32)
    x[0, 0, :len(SPECIALS)] = SPECIALS
    x[0, 1] = np.arange(w1) * 0.5 - 8.0        # integers and half-integers
    x[1, 2] = np.arange(w1) - np.float32(1.9e-6)   # just below integers
    x[1, 1] = np.arange(w1) + np.float32(1.9e-6)   # just above
    vcat = rng.normal(size=(b, h, w1, sum(widths))).astype(np.float32)
    return vcat, x, widths, radius


@pytest.mark.parametrize("name", list(CASES))
def test_windowed_form_bitwise_equals_plain(name):
    """The emulated kernel, never using a window entry it did not read
    (those are NaN), equals the plain version bit for bit, and no tap's
    floor falls outside its three pairs of the window; the CPU wrapper is
    the plain version."""
    vcat, x, widths, radius = _case(name)
    v, xt = torch.from_numpy(vcat), torch.from_numpy(x)
    stats = {}
    got = emulate(v, widths, xt, radius, stats)
    assert stats.get("elsewhere", 0) == 0
    want = cuda_vol.vol_lookup_plain(v, widths, xt, radius)
    assert got.shape == want.shape == x.shape + (len(widths)
                                                 * (2 * radius + 1),)
    assert _int_bits(got, want)
    assert _int_bits(cuda_vol.vol_lookup(v, widths, xt, radius), want)
    assert bool(want.isnan().any()) and bool((want != 0).any())


def test_rounding_crossings_take_the_window():
    """x = 127.99999 rounds level 0's tap t_5 up to 129.0: the window takes
    K+2 columns and that tap sits one column past its place; x =
    0.99999994 rounds t_0 up to -3.0 while t_4 stays below 1: a tap one
    column before its place.  Both stay in the windowed form."""
    widths, radius = (240, 120), 4
    x = torch.tensor([[[127.99999, 0.99999994, 50.25]]])
    vcat = torch.from_numpy(np.random.default_rng(8).normal(
        size=(1, 1, 3, sum(widths))).astype(np.float32))
    stats = {}
    got = emulate(vcat, widths, x, radius, stats)
    assert _int_bits(got, cuda_vol.vol_lookup_plain(vcat, widths, x, radius))
    k = 2 * radius + 1
    assert stats["cols%d" % (k + 2)] >= 1 and stats["cols%d" % (k + 1)] >= 1
    assert stats["late"] >= 1 and stats["early"] >= 1
    assert stats["per_tap"] == 0


def test_windows_reaching_2_24_take_the_per_tap_form():
    """Past 2^24 the floats are 2 apart: at x = 2^24 + 4 and radius 3 the
    tap t_0 = x - 3 rounds down to x - 4 and t_6 = x + 3 up to x + 4, so
    the window would take 10 columns, more than K+2 = 9, and plain's f + 1
    rounds back to f there; on a level that wide, the item reads each
    tap's columns where they lie (no window reaches 2^24): bitwise equal
    to plain.  Beside it, x =
    2^23 - 0.5 crosses into the binade of 1-spaced floats mid-window and
    x = 2^24 - 9 ends just below 2^24: both stay in the windowed form."""
    w = 2 ** 24 + 16
    x = torch.tensor([[[2.0 ** 24 + 4, 2.0 ** 23 - 0.5, 2.0 ** 24 - 9.0]]])
    vcat = torch.arange(w, dtype=torch.float32).expand(1, 1, 3, w)
    stats = {}
    got = emulate(vcat, (w,), x, 3, stats)
    want = cuda_vol.vol_lookup_plain(vcat, (w,), x, 3)
    assert _int_bits(got, want)
    assert stats["per_tap"] == 1 and stats["elsewhere"] == 0
    assert bool((want[0, 0, 0] != 0).all())


@pytest.mark.parametrize("name", ["recipe_levels", "serving_widths",
                                  "zero_width_level", "radius0",
                                  "radius8_per_tap"])
def test_windowed_form_matches_jax(name):
    """The emulated kernel against ``pallas_lookup_pyramid_flat`` in
    interpret mode, the multi-level form over the lane-padded level
    concat: NaN where JAX has NaN, within 1e-6 elsewhere (two products
    summed in both; JAX adds the zero-weight columns too)."""
    vcat, x, widths, radius = _case(name)
    got = emulate(torch.from_numpy(vcat), widths, torch.from_numpy(x),
                  radius).numpy()
    b, h, w1, _ = vcat.shape
    levels, off = [], 0
    for w in widths:
        lv = jnp.asarray(vcat[..., off:off + w])
        off += w
        levels.append(jpc.pad_vol_lane(jpc.preflatten_volume(lv)))
    w2s = tuple(int(v.shape[2]) for v in levels)
    offs = np.arange(-radius, radius + 1, dtype=np.float32)
    taps = np.concatenate([x[..., None] / np.float32(2.0 ** lvl) + offs
                           for lvl in range(len(widths))], -1)
    want = np.asarray(jpc.pallas_lookup_pyramid_flat(
        jnp.concatenate(levels, axis=2), jnp.asarray(taps), w2s))
    assert want.shape == got.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               rtol=0, atol=1e-6)
