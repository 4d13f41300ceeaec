"""Row 6 (``csrc/corr_vol_bwd.cu``, the VJP of the precomputed-volume
lookup): the kernel's windowed form, emulated on the CPU, bit for bit.

The kernel runs only on the card.  It writes +0 outside each clean
level's window [floor(t_0), floor(t_{K-1}) + 1] (clipped to the level),
the ascending K-term sum inside it, and the dense per-column sum on a
level that is not clean (a NaN coordinate or a non-finite cotangent) or
whose window is wider than K+2 columns.  These tests build that output in
torch, in the kernel's arithmetic, and hold it bitwise (the int32 views)
against the plain version ``cuda_vol.vol_lookup_backward_plain``, the
dense form, and against ``jax.vjp`` of the JAX package's
``pallas_lookup`` (its ``_lookup_bwd_kernel`` in interpret mode) within
1e-5, with NaN and +-inf where it has them.  Inputs are made with numpy
from a seed.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raftstereo_tpu.ops import pallas_corr as jpc
from raftstereo_tpu_torch.ops import _build, cuda_vol
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse


def window_width(k: int) -> int:
    """The most window columns a clean level takes the windowed form for,
    the source's ``KW = K + 2``."""
    src = _build.sources()["corr_vol_bwd"].read_text()
    assert re.search(r"KW = K \+ 2;", src)
    return k + 2


def _hat_sum(t, g, col):
    """sum_k g_k * max(0, 1 - |col - t_k|), k ascending from +0, each
    product and add rounded once in fp32, NaN weights kept.  t, g (..., K),
    col (..., N) -> (..., N)."""
    zero = torch.zeros(())
    acc = torch.zeros(col.shape)
    for k in range(t.shape[-1]):
        w = torch.maximum(1.0 - (col - t[..., k, None]).abs(), zero)
        acc = acc + g[..., k, None] * w
    return acc


def emulate(x, g, widths, radius):
    """``vol_lookup_backward`` as the kernel computes it: x (B, H, W1), g
    (B, H, W1, L*K) -> dvcat (B, H, W1, sum(widths))."""
    k = 2 * radius + 1
    kw = window_width(k)
    parts = []
    for lvl, w in enumerate(widths):
        t = cuda_vol.level_taps(x, lvl, radius)             # (..., K)
        gl = g[..., lvl * k:(lvl + 1) * k].float()
        clean = ~torch.isnan(x) & torch.isfinite(gl).all(-1)
        lo = torch.floor(t[..., 0]).clamp_min(0.0)
        hi = torch.minimum(torch.floor(t[..., -1]) + 1.0,
                           torch.tensor(float(w - 1)))
        has = lo <= hi                                       # False for NaN
        start = torch.where(has, lo, 0.0).long()
        count = torch.where(has, torch.where(has, hi, 0.0).long() - start + 1,
                            0)
        dense = ~clean | (count > kw)
        if w == 0:
            parts.append(torch.zeros(x.shape + (0,)))
            continue
        # the window's columns: their K-term sums, scattered into +0 (the
        # columns past the window into a spare column w, then dropped)
        d = torch.arange(kw)
        col = start[..., None] + d                           # (..., KW)
        valid = (d < count[..., None]) & ~dense[..., None]
        sums = _hat_sum(t, gl, col.float())
        out = torch.zeros(x.shape + (w + 1,))
        out.scatter_(-1, torch.where(valid, col, w), sums)
        out = out[..., :w]
        # a level that is not clean, or too wide: the dense sum everywhere
        full = _hat_sum(t, gl, torch.arange(w, dtype=torch.float32)
                        .expand(x.shape + (w,)))
        parts.append(torch.where(dense[..., None], full, out))
    return torch.cat(parts, dim=-1)


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# (widths, radius, specials): W1 = 16 pixels per row, 2 rows.
CASES = {
    "int_half_negative": ((16, 8, 4, 2), 4, "int_half"),
    "past_edges_huge": ((16, 8, 4, 2), 4, "huge"),
    "widths_0_1_2": ((2, 1, 0), 1, "int_half"),
    "radius0": ((16, 8), 0, "int_half"),
    "radius1_g_specials": ((16, 8, 4), 1, "g_specials"),
    "radius8_nonfinite": ((16, 8, 4, 2), 8, "nonfinite"),
    "one_level": ((16,), 4, "nonfinite"),
    "eight_levels": ((64, 32, 16, 8, 4, 2, 1, 0), 2, "nonfinite"),
    "random_field": ((45, 22, 11, 5), 4, "random"),
}


def _case(name, seed=11):
    """(x (1, 2, W1), g (1, 2, W1, L*K), widths, radius), numpy fp32."""
    widths, radius, special = CASES[name]
    k = 2 * radius + 1
    w1 = 16
    rng = np.random.default_rng(seed)
    x = (np.arange(w1) - rng.uniform(0, 12, (1, 2, w1))).astype(np.float32)
    g = rng.normal(size=(1, 2, w1, len(widths) * k)).astype(np.float32)
    if special == "int_half":
        # exact integers and half-integers, negative ones among them
        x[0, 0] = np.arange(w1) - 6.0
        x[0, 1] = np.arange(w1) * 0.5 - 3.5
    if special == "huge":
        x[0, 0, :8] = [-3.0, 19.5, -40.25, 60.0, 1e7, -1e7, 1e30, -1e30]
        x[0, 1, :4] = [2.0 ** 23 + 1, -(2.0 ** 24) - 3, 1.5e7 + 0.5, 3e38]
        x[0, 1, 4:6] = [np.inf, -np.inf]
    if special == "g_specials":
        g[0, 0, :, 0] = -0.0
        g[0, 0, 3, :] = -0.0
        g[0, 1, :, 1] = 1e-40          # subnormal
        g[0, 1, 5, :] = -3e-42
        x[0, 1, 7] = -0.0
    if special == "nonfinite":
        lv1 = min(1, len(widths) - 1)
        x[0, 0, 3] = np.nan
        x[0, 0, 6] = 9.0     # the middle tap between two columns of lv1
        g[0, 0, 6, lv1 * k + radius] = np.inf
        g[0, 1, 2, 0] = -np.inf
        g[0, 1, 9, (lv1 + 1) * k - 1] = np.nan
        g[0, 1, 12, :k] = 1e-40
        g[0, 1, 13, 0] = -0.0
    if special == "random":
        x[:] = (np.arange(w1) * 2.8 - rng.uniform(-5, 60, (1, 2, w1))
                ).astype(np.float32)
    return x, g, widths, radius


@pytest.mark.parametrize("name", list(CASES))
def test_windowed_form_bitwise_equals_plain(name):
    """The emulated kernel equals the dense plain version bit for bit:
    +0 outside every clean window, the same K-term sums inside, the same
    NaN and +-inf on the levels that are not clean."""
    x, g, widths, radius = _case(name)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    got = emulate(xt, gt, widths, radius)
    want = cuda_vol.vol_lookup_backward_plain(xt, gt, widths, radius)
    assert got.shape == want.shape == x.shape + (sum(widths),)
    assert _same_bits(got, want)
    # the wrapper takes the plain version on the CPU
    assert _same_bits(cuda_vol.vol_lookup_backward(xt, gt, widths, radius),
                      want)
    if CASES[name][2] == "nonfinite":
        assert bool(want.isnan().any())
    if CASES[name][2] == "nonfinite":
        assert bool(want.isinf().any())   # an inf g on its two columns
    # every zero is +0: the ascending sum from +0 never turns -0
    assert bool((want == 0).any())
    assert not bool(torch.signbit(want[want == 0]).any())


@pytest.mark.parametrize("name", ["int_half_negative", "past_edges_huge",
                                  "radius8_nonfinite", "random_field"])
def test_windowed_form_matches_jax(name):
    """The emulated kernel, level by level, against ``jax.vjp`` of
    ``pallas_lookup`` (the Pallas lookup's custom VJP, interpret mode):
    NaN and +-inf where JAX has them, within 1e-5 elsewhere (sums of K
    products of O(1) terms, as ``test_torch_port_corr.py`` holds the
    plain version)."""
    x, g, widths, radius = _case(name)
    k = 2 * radius + 1
    got = emulate(torch.from_numpy(x), torch.from_numpy(g), widths,
                  radius).numpy()
    rng = np.random.default_rng(0)
    off = 0
    for lvl, w in enumerate(widths):
        taps = ((x * np.float32(1.0 / 2 ** lvl))[..., None]
                + np.arange(-radius, radius + 1, dtype=np.float32))
        vol = rng.normal(size=x.shape + (w,)).astype(np.float32)
        _, vjp = jax.vjp(jpc.pallas_lookup, jnp.asarray(vol),
                         jnp.asarray(taps))
        want = np.asarray(vjp(jnp.asarray(g[..., lvl * k:(lvl + 1) * k]))[0])
        mine = got[..., off:off + w]
        np.testing.assert_array_equal(np.isnan(mine), np.isnan(want))
        np.testing.assert_array_equal(mine[np.isinf(want)],
                                      want[np.isinf(want)])
        np.testing.assert_allclose(np.nan_to_num(mine, posinf=0, neginf=0),
                                   np.nan_to_num(want, posinf=0, neginf=0),
                                   rtol=0, atol=1e-5)
        off += w


def test_outside_window_is_positive_zero_without_arithmetic():
    """On a clean level every column outside the window has hat weight
    +0 at every tap, so the dense sum there is +0 whatever the finite
    cotangents (-0, subnormals, huge values): what the kernel writes
    without computing it."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((np.arange(32) + rng.uniform(-40, 40, 32))
                         .astype(np.float32))[None, None]
    g = torch.from_numpy(np.concatenate([
        rng.uniform(-3e38, 3e38, (1, 1, 32, 9)),
        np.full((1, 1, 32, 9), -0.0)], axis=-1).astype(np.float32))
    widths, radius = (40, 20), 4
    want = cuda_vol.vol_lookup_backward_plain(x, g, widths, radius)
    got = emulate(x, g, widths, radius)
    assert _same_bits(got, want)
    inside = torch.zeros_like(want, dtype=torch.bool)
    off = 0
    for lvl, w in enumerate(widths):
        t = cuda_vol.level_taps(x, lvl, radius)
        j = torch.arange(w, dtype=torch.float32)
        inside[..., off:off + w] = ((j >= torch.floor(t[..., :1]))
                                    & (j <= torch.floor(t[..., -1:]) + 1))
        off += w
    out = want[~inside]
    assert out.numel() > 0 and bool((out == 0).all())
    assert not bool(torch.signbit(out).any())
