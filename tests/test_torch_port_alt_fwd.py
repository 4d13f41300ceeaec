"""Row 1 (``csrc/alt_corr.cu``, the model's on-demand lookup): the
kernel's tiling and its summation order, on the CPU.

The kernel runs only on the card.  These tests hold an emulation of it:
a block per (image row, tile of kTilePix pixels); per level the span of
columns that the tile's windows cover, allotted rows of a kSpanRows-row
staging buffer in level order, a level that does not fit taking the
wide-span path (its fmap2 rows read from global memory, a warp per pixel:
each lane's 16-byte slots in fp32 FMAs, then the lanes' sums by xor
shuffles); each staged window dot summed by its own thread in fp32 FMAs,
over 128-byte channel chunks, and within a chunk over 16-byte slots in
the order (s + lane) mod 8.  The
partition is checked to give every window column a pixel reads a staged
row or the wide-span path, and the emulated sums are held against the
plain version (``cuda_alt.alt_corr_plain``) within ``chip_smoke``'s
``LOOKUP_TOL`` (fp32) or 1 bf16 ulp (``LOOKUP_BF16_ULPS``), and against
the JAX package's Pallas radial kernel (``_alt_pyr_radial_kernel``, in
interpret mode) within ``LOOKUP_TOL``.  Inputs are made with numpy from a
seed.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raftstereo_tpu.ops import corr as jcorr
from raftstereo_tpu_torch.ops import _build, cuda_alt
from raftstereo_tpu_torch.ops.corr import build_corr_state
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse

LOOKUP_TOL = 1e-4          # chip_smoke.LOOKUP_TOL: abs, fp32 dots reordered
LOOKUP_BF16_ULPS = 1.0     # chip_smoke.LOOKUP_BF16_ULPS, of max(1, |plain|)
BF16_ULP = 2.0 ** -7
LEVELS, RADIUS = 4, 4


def geometry():
    """The source's tiling constants."""
    src = _build.sources()["alt_corr"].read_text()
    names = ("kThreads", "kTilePix", "kSpanRows", "kRowBytes")
    return {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
            for n in names}


def groups(nlev, radius):
    """Column groups per window: ``launch``'s
    max(1, min(2r+2, kThreads / (kTilePix * L)))."""
    g = geometry()
    return max(1, min(2 * radius + 2, g["kThreads"] // (g["kTilePix"]
                                                          * nlev)))


# ------------------------------------------------------------- the tiling

def plan(xrow, widths, radius):
    """The kernel's span plan for one image row: per tile, per level
    (mode, lo, hi) with mode "staged", "wide" or "empty"."""
    g = geometry()
    tp, cap = g["kTilePix"], g["kSpanRows"]
    tiles = []
    for p0 in range(0, len(xrow), tp):
        xs = xrow[p0:p0 + tp]
        used, levels = 0, []
        for lvl, w in enumerate(widths):
            b0 = np.floor(xs * np.float32(1.0 / (1 << lvl)))
            with np.errstate(invalid="ignore"):
                hits = (b0 - radius <= w - 1) & (b0 + radius + 1 >= 0)
            if not hits.any():
                levels.append(("empty", 0, -1))
                continue
            lo = max(int(b0[hits].min()) - radius, 0)
            hi = min(int(b0[hits].max()) + radius + 1, w - 1)
            if lo > hi:
                levels.append(("empty", lo, hi))
            elif used + hi - lo + 1 <= cap:
                levels.append(("staged", lo, hi))
                used += hi - lo + 1
            else:
                levels.append(("wide", lo, hi))
        tiles.append(levels)
    return tiles


def _fma_chain(a, b, acc):
    """acc + a * b with the product exact (fp32 FMA; the float64 sum
    rounded once to fp32)."""
    return (acc.double() + a.double() * b.double()).float()


def wide_mask(x, widths, radius):
    """(N, L) bool: the pixel's tile takes level l's wide-span path."""
    tp = geometry()["kTilePix"]
    rows = x.reshape(-1, x.shape[-1]).numpy()
    mask = np.zeros((rows.shape[0], rows.shape[1], len(widths)), bool)
    for r, row in enumerate(rows):
        for t, levels in enumerate(plan(row, widths, radius)):
            for lvl, (mode, _, _) in enumerate(levels):
                mask[r, t * tp:(t + 1) * tp, lvl] = mode == "wide"
    return torch.from_numpy(mask.reshape(-1, len(widths)))


def _wide_dots(a, rows2, vec):
    """``wide_dots``'s sums: a (N, C), rows2 (N, D, C) -> (N, D).  Lane i
    takes the 16-byte slot i of each 512-byte piece of the row, pieces
    ascending, in fp32 FMAs; then the 32 lanes' sums by xor shuffles
    (offsets 16, 8, 4, 2, 1)."""
    c = a.shape[-1]
    piece = 32 * vec
    order = (torch.arange(0, c, piece)[None, :, None]
             + torch.arange(32)[:, None, None] * vec
             + torch.arange(vec)[None, None, :]).reshape(32, -1)
    av, bv = a[:, order], rows2[:, :, order]           # (N, 32, n), (N, D, 32, n)
    acc = torch.zeros(bv.shape[:3])
    for t in range(order.shape[1]):
        acc = _fma_chain(av[:, None, :, t], bv[..., t], acc)
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ off]
    return acc[..., 0]


def emulate(fmap1, f2cat, widths, x, radius, out_dtype=torch.float32):
    """``alt_corr`` as the kernel computes it: fmap1 (B, H, W1, C), f2cat
    (B, H, W2cat, C) fp32 or bf16, x (B, H, W1) -> (B, H, W1, L*K)."""
    g = geometry()
    b, h, w1, c = fmap1.shape
    elem = fmap1.element_size()
    vec = 16 // elem                      # values in a 16-byte slot
    chunk = g["kRowBytes"] // elem        # channels per staged chunk
    k = 2 * radius + 1
    nlev = len(widths)
    offs = [sum(widths[:i]) for i in range(nlev)]
    f1 = fmap1.float().reshape(-1, c)
    f2 = f2cat.float().reshape(b * h, -1, c)
    xr = x.reshape(-1).float()
    npix = xr.numel()
    rows = torch.arange(npix) // w1
    # each pixel's channel order: chunks ascending, then slots (s + lane)
    # mod 8 for s = 0..7, then the slot's values ascending
    lane = torch.arange(npix) % w1 % g["kTilePix"] % 32
    s = torch.arange(8)
    slot = (s[None, :] + lane[:, None]) % 8                    # (N, 8)
    order = (torch.arange(0, c, chunk)[None, :, None, None]
             + slot[:, None, :, None] * vec
             + torch.arange(vec)[None, None, None, :]).reshape(npix, c)
    a = torch.gather(f1, 1, order)                               # (N, C)
    wide = wide_mask(x, widths, radius)                          # (N, L)
    wins = []
    for lvl, w in enumerate(widths):
        xl = xr * (1.0 / float(1 << lvl))
        b0 = torch.floor(xl)
        jf = b0[:, None] + torch.arange(-radius, radius + 2)     # (N, D)
        valid = (jf >= 0) & (jf <= w - 1)                        # NaN: False
        col = torch.where(valid, jf, 0.0).long() + offs[lvl]
        if w == 0:
            wins.append(torch.zeros(npix, k + 1))
            continue
        rows2 = f2[rows[:, None].expand_as(col), col]            # (N, D, C)
        bv = torch.gather(rows2, 2, order[:, None, :].expand_as(rows2))
        acc = torch.zeros(npix, k + 1)
        for t in range(c):
            acc = _fma_chain(a[:, None, t], bv[..., t], acc)
        wl = wide[:, lvl]
        if wl.any():
            acc[wl] = _wide_dots(f1[wl], rows2[wl], vec)
        scale = torch.tensor(1.0 / float(c) ** 0.5)
        wins.append(torch.where(valid, acc * scale, 0.0))
    cols = []
    for lvl, win in enumerate(wins):
        xl = xr * (1.0 / float(1 << lvl))
        fr = xl - torch.floor(xl)
        for t in range(k):
            cols.append(win[:, t] * (1.0 - fr) + win[:, t + 1] * fr)
    return torch.stack(cols, -1).reshape(b, h, w1, nlev * k).to(out_dtype)


# ------------------------------------------------------------------ cases

def _field(case, w, rng, h=2):
    """x (1, h, w) for one case, numpy fp32."""
    i = np.arange(w, dtype=np.float32)
    if case == "smooth":     # a low-frequency sine in [-60, 0]
        yy = np.arange(h, dtype=np.float32)[:, None]
        disp = -30.0 + 30.0 * np.sin(2 * np.pi * (i / 97.0 + yy / 13.0))
    elif case == "diverged":  # windows past every level but a few
        disp = -300.0 - 400.0 * rng.uniform(size=(h, w))
        disp[:, :40:13] = -20.0 * rng.uniform(size=(h, w))[:, :40:13]
    elif case == "jump":     # 8-pixel stripes 230 columns apart
        disp = np.where((i // 8) % 2 == 1, -230.0, 0.0) - rng.uniform(
            0, 3, (h, w))
    else:                    # the smoke's random field in [-60, 0]
        disp = -60.0 * rng.uniform(size=(h, w))
    x = (i + disp).astype(np.float32)[None]
    if case == "nan_outside":
        x[0, 0, :6] = [np.nan, -200.5, w + 300.25, 1e6, -1e30, np.inf]
        x[0, 1, 3] = np.nan
        x[0, 1, 10:12] = [-3.5, w + 1.75]   # partly past each edge
    return x


# (field, W1, C, fmap dtype): W1 70 and 40 are not multiples of the
# 32-pixel tile (tail tiles of 6 and 8), W1 320 makes room for jumps wider
# than the 224-row staging buffer.
CASES = {
    "smooth_w70": ("smooth", 70, 128, torch.float32),
    "random_w96": ("random", 96, 128, torch.float32),
    "jump_w320": ("jump", 320, 128, torch.float32),
    "nan_outside_w40": ("nan_outside", 40, 128, torch.float32),
    "random_c256_w45": ("random", 45, 256, torch.float32),
    "diverged_w96": ("diverged", 96, 128, torch.float32),
    "smooth_bf16_w70": ("smooth", 70, 256, torch.bfloat16),
    "random_bf16_w40": ("random", 40, 256, torch.bfloat16),
    "jump_bf16_w320": ("jump", 320, 256, torch.bfloat16),
}


def _inputs(name, seed=7):
    field, w, c, dtype = CASES[name]
    rng = np.random.default_rng(seed)
    h = 2
    f1 = rng.normal(size=(1, h, w, c)).astype(np.float32)
    f2 = rng.normal(size=(1, h, w, c)).astype(np.float32)
    x = _field(field, w, rng, h)
    return f1, f2, x, dtype


def _state(f1, f2, dtype):
    return build_corr_state(torch.from_numpy(f1), torch.from_numpy(f2),
                            LEVELS, corr_dtype=dtype)


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("nlev", range(1, 9))
def test_units_fit_the_block_and_cover_every_window(nlev):
    """At every level count and radius the kernel takes, the (pixel,
    level, column group) units fit the block's threads and the groups
    cover the K+1 window columns; a warp's 32 lanes share one level."""
    g = geometry()
    assert g["kTilePix"] % 32 == 0 and g["kRowBytes"] == 128
    for radius in range(1, 9):
        grp = groups(nlev, radius)
        per = -(-(2 * radius + 2) // grp)
        assert g["kTilePix"] * nlev * grp <= g["kThreads"]
        assert grp * per >= 2 * radius + 2


@pytest.mark.parametrize("name", list(CASES))
def test_spans_cover_every_window_column(name):
    """Every in-level window column of every pixel that meets a level lies
    in its tile's staged span, or the tile-level takes the wide-span path;
    no span is larger than the staging buffer; the jump field takes the
    wide-span path and the smooth field never does."""
    f1, f2, x, dtype = _inputs(name)
    st = _state(f1, f2, dtype)
    tp, cap = geometry()["kTilePix"], geometry()["kSpanRows"]
    wide = 0
    for row in x.reshape(-1, x.shape[-1]):
        for t, levels in enumerate(plan(row, st.widths, RADIUS)):
            staged = sum(hi - lo + 1 for m, lo, hi in levels if m == "staged")
            assert staged <= cap
            wide += sum(m == "wide" for m, _, _ in levels)
            xs = row[t * tp:(t + 1) * tp]
            for lvl, (mode, lo, hi) in enumerate(levels):
                w = st.widths[lvl]
                b0 = np.floor(xs * np.float32(1.0 / (1 << lvl)))
                for d in range(2 * RADIUS + 2):
                    with np.errstate(invalid="ignore"):
                        j = b0 - RADIUS + d
                        used = (j >= 0) & (j <= w - 1)
                    if used.any():
                        assert mode in ("staged", "wide")
                    if mode == "staged":
                        assert ((j[used] >= lo) & (j[used] <= hi)).all()
    field = CASES[name][0]
    if field == "jump":
        assert wide > 0
    if field == "smooth":
        assert wide == 0
    if field == "diverged":   # tiles whose windows meet no level at all
        assert any(all(m == "empty" for m, _, _ in levels)
                   for row in x.reshape(-1, x.shape[-1])
                   for levels in plan(row, st.widths, RADIUS))


@pytest.mark.parametrize("name", list(CASES))
def test_emulation_within_tol_of_plain(name):
    """The emulated kernel against ``alt_corr_plain``: NaN at NaN pixels,
    zeros where a window misses its level, within ``LOOKUP_TOL`` (fp32) or
    1 bf16 ulp of max(1, |plain|) (bf16 feature maps, bf16 out)."""
    f1, f2, x, dtype = _inputs(name)
    st = _state(f1, f2, dtype)
    xt = torch.from_numpy(x)
    got = emulate(st.fmap1, st.f2cat, st.widths, xt, RADIUS, dtype)
    want = cuda_alt.alt_corr_plain(st.fmap1, st.f2cat, st.widths, xt,
                                   RADIUS, dtype)
    assert got.dtype == want.dtype == dtype
    got, want = got.float(), want.float()
    assert torch.equal(got.isnan(), want.isnan())
    # a NaN or infinite coordinate gives f = NaN: the whole pixel is NaN
    assert torch.equal(got.isnan().all(-1), torch.from_numpy(~np.isfinite(x)))
    ok = ~want.isnan()
    err = (got[ok] - want[ok]).abs()
    if dtype == torch.bfloat16:
        assert float((err / want[ok].abs().clamp_min(1.0)).max()) <= (
            LOOKUP_BF16_ULPS * BF16_ULP)
    else:
        assert float(err.max()) <= LOOKUP_TOL
    if CASES[name][0] == "nan_outside":   # windows past every level
        assert bool((got[0, 0, 1:5] == 0).all())


@pytest.mark.parametrize("name", ["smooth_w70", "jump_w320",
                                  "nan_outside_w40"])
def test_emulation_matches_jax(name):
    """The emulated kernel against the JAX package's ``pallas_alt``
    lookup (the Pallas radial kernel in interpret mode) on the same
    inputs: NaN where JAX has NaN, within ``LOOKUP_TOL`` elsewhere."""
    f1, f2, x, dtype = _inputs(name)
    fn = jcorr.make_corr_fn("pallas_alt", jnp.asarray(f1), jnp.asarray(f2),
                            LEVELS, RADIUS)
    want = np.asarray(fn(jnp.asarray(x)[..., None]))
    st = _state(f1, f2, dtype)
    got = emulate(st.fmap1, st.f2cat, st.widths, torch.from_numpy(x),
                  RADIUS).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=LOOKUP_TOL)
