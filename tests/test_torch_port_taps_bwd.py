"""Row 4 with general taps (``csrc/alt_corr_taps_bwd.cu``, the VJP of the
lookup at caller-given taps): the kernels' partition of the work and
their summation order, on the CPU.

The kernels run only on the card.  These tests hold an emulation of
them.  The lists kernel, a block per image row: the tables of each tile
of pixels (each tap's first column and its coefficients g * (1 - f) and
g * f); df1's runs, one per pixel walk over the levels and taps in order,
consecutive equal columns merged; df2's column-major entries, built tile
by tile and chunk by chunk of columns from per-column pixel masks (a
column's start from the scan of the masks' counts, an entry's rank from
the pixels below it in the mask), each entry the sum in tap order of its
pixel's taps on the column; the flags of the dense hat's non-finite
values.  The sums kernel, a block per (image row, 128-channel slice, the
source's kSlice): one fmaf chain per channel over a pixel's runs (df1)
or a column's entries (df2), in list order.  The emulation is held
against the plain version (``alt_corr_taps_backward_plain``) within
``chip_smoke.BACKWARD_TOL``, NaN and +-inf exactly where it has them;
bitwise against an emulation of the first form's order (one scan of the
row's pixels per column, one walk of the taps per pixel), which the
kernel keeps; and against ``jax.grad`` through the JAX package's
``_make_alt_pyr`` (its ``_alt_pyr_bwd_kernel`` in interpret mode) at the
tolerances of ``tests/test_torch_port_lookup_norm.py``.  Inputs are made
with numpy from a seed.
"""

import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raftstereo_tpu.ops import pallas_alt as jalt
from raftstereo_tpu_torch.ops import _build
from raftstereo_tpu_torch.ops import alt_lookup as talt
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse

# chip_smoke.py's BACKWARD_TOL: each gradient within 1e-4 x max(1,
# |plain|) of the plain version (sums of up to 2*K products per column,
# in another order).
BACKWARD_TOL = 1e-4
FAR, NAN_TAP = 2 ** 30, 2 ** 30 + 1  # the source's kFar and kNan


# ------------------------------------------------------------- geometry

def _source():
    return _build.source_text("alt_corr_taps_bwd")


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _source())
               .group(1))


def slice_width():
    """Channels per block of the sums kernel: 32 lanes x kVec."""
    assert re.search(r"kSlice = 32 \* kVec;", _source())
    return 32 * _const("kVec")


def max_smem():
    return _const("kMaxSmem")


def plan(w1, w2cat, lk):
    """The lists kernel's (pixels per tile, columns per chunk), as the
    source's ``plan``: the whole row and pyramid where the tables (12 B a
    tap) and the masks (4 B a column per 32 pixels) fit, else the largest
    tile, then narrower chunks; None where not one pixel fits."""
    src = _source()
    assert "return 12L * tile * lk + 4L * chunk * ((tile + 31) / 32);" in src
    assert "const int chunks[] = {w2cat, 1024, 256, 32};" in src
    for cw in (w2cat, 1024, 256, 32):
        cw = max(1, min(cw, w2cat))
        t = max(w1, 1)
        while t >= 1:
            if 12 * t * lk + 4 * cw * ((t + 31) // 32) <= max_smem() - 256:
                return t, cw
            t = (t - 1) // 32 * 32 if t > 32 else t // 2
    return None


def test_plan_keeps_the_recipe_row_whole():
    """At the recipe's op shape (180 pixels, 337 pyramid columns, 36 taps)
    one tile and one chunk hold the row: the masks of pass 1 serve pass
    2.  A 1248-pixel row walks in tiles; 19,000 taps a pixel fit one
    pixel's tables (the first form's limit: 12 bytes a tap), 20,000 do
    not."""
    assert plan(180, 337, 36) == (180, 337)
    tile, chunk = plan(1248, 2340, 36)
    assert tile < 1248 and tile % 32 == 0 and chunk == 2340
    assert plan(3, 40, 19000) is not None
    assert plan(3, 40, 20000) is None
    assert slice_width() == 128


def work_bytes():
    """The source's kWorkBytes: the workspace of a batch of rows."""
    m = re.search(r"constexpr long kWorkBytes = (\d+)L << (\d+);", _source())
    return int(m.group(1)) << int(m.group(2))


def layout(rows, w1, w2cat, lk):
    """Bytes of the workspace of ``rows`` rows, as the source's ``layout``:
    runs (2 L K a pixel), entries (W1 min(2 L K, W2cat) a row), run counts,
    column starts and cursors, the row flags, each part rounded up to 256
    bytes."""
    src = _source()
    assert "wk->h = (long)w1 * min(2L * lk, (long)w2cat);" in src
    assert "at += (bytes + 255) / 256 * 256;" in src
    flags = 1 + 2 * _const("kMaxLevels")
    parts = (rows * w1 * 2 * lk * 8, rows * w1 * min(2 * lk, w2cat) * 8,
             rows * w1 * 4, rows * (w2cat + 1) * 4, rows * w2cat * 4,
             rows * flags * 4)
    return sum((p + 255) // 256 * 256 for p in parts)


def batch_rows(rows, w1, w2cat, lk):
    """Rows per batch, as the source's ``batch_rows``: as many as
    kWorkBytes holds, at least one."""
    assert ("return max(1L, min(rows, kWorkBytes / one));"
            in _source())
    return max(1, min(rows, work_bytes() // layout(1, w1, w2cat, lk)))


@pytest.mark.parametrize("rows,w1,w2cat,lk,batches", [
    (480, 180, 337, 36, 1), (144, 240, 450, 36, 1), (480, 180, 96, 19000, 120),
    (2, 1248, 2340, 19000, 2), (7, 1, 1, 1, 1)],
    ids=["recipe", "serving", "near_limit", "row_over_cap", "tiny"])
def test_batches_bound_the_workspace(rows, w1, w2cat, lk, batches):
    """The lists' workspace takes up to 32 bytes a tap; a call runs in
    batches of rows whose workspace stays within kWorkBytes (256 MiB), or
    one row a batch where a row needs more.  The recipe's and the serving
    op shapes run in one batch, 19,000 taps a pixel at the training rows in
    120 batches of 4 rows."""
    b = batch_rows(rows, w1, w2cat, lk)
    assert -(-rows // b) == batches
    ws = layout(b, w1, w2cat, lk)
    assert ws <= max(work_bytes(), layout(1, w1, w2cat, lk))
    assert ws <= b * layout(1, w1, w2cat, lk)  # each part rounded once
    assert layout(1, w1, w2cat, lk) <= 32 * w1 * lk + 256 * 6 + 16 * (
        w1 + 2 * w2cat + 20)


# ------------------------------------------------------------- emulation

def _fma(a, b, c):
    """fmaf in fp32 (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def tables(taps, g, widths):
    """Per tap (rows, W1, L*K): first column b (FAR: none; NAN_TAP), and
    a0 = g * (1 - f), a1 = g * f, each product and difference rounded."""
    kk = taps.shape[-1] // len(widths)
    w = torch.tensor(widths, dtype=torch.float32).repeat_interleave(kk)
    nan = taps.isnan() | g.isnan()
    inside = (taps > -1.0) & (taps < w) & ~nan
    b0 = torch.floor(torch.where(inside, taps, torch.zeros_like(taps)))
    f = taps - b0
    a0 = torch.where(inside, g * (1.0 - f), g)
    a1 = torch.where(inside, g * f, torch.zeros_like(g))
    b = torch.where(inside, b0.long(), torch.full_like(b0, FAR).long())
    b = torch.where(nan, torch.full_like(b, NAN_TAP), b)
    a0 = torch.where(nan, torch.zeros_like(a0), a0)
    a1 = torch.where(nan, torch.zeros_like(a1), a1)
    return b, a0, a1


def lists(taps, g, widths, tile=None, chunk=None):
    """The lists kernel, all rows at once: df1's runs (a per-pixel list of
    (column, coefficient)) with each pixel's NaN flag; df2's entries (a
    per-row list of (pixel, coefficient) and each column's start); the
    row flags (levels a NaN poisons; per level the columns every infinite
    g's tap weights)."""
    rows, w1, lk = taps.shape
    nlev = len(widths)
    kk = lk // nlev
    w2cat = sum(widths)
    offs = [sum(widths[:i]) for i in range(nlev)]
    if tile is None:
        tile, chunk = plan(w1, w2cat, lk)
    b, a0, a1 = tables(taps, g, widths)

    # flags
    lvl = torch.arange(lk) // kk
    w_of = torch.tensor(widths)[lvl]
    real = w_of > 0
    poison = torch.zeros(rows, nlev, dtype=torch.bool)
    keep_lo = torch.full((rows, nlev), -2 ** 31, dtype=torch.long)
    keep_hi = torch.full((rows, nlev), 2 ** 31 - 1, dtype=torch.long)
    for lv in range(nlev):
        sel = (lvl == lv) & real
        if not bool(sel.any()):  # a level of width 0 has no flags
            continue
        bl = b[:, :, sel].reshape(rows, -1)
        infg = torch.isinf(a0[:, :, sel]).reshape(rows, -1) & (bl != NAN_TAP)
        poison[:, lv] = (bl == NAN_TAP).any(1)
        lo = torch.where(bl == FAR, 2 ** 31 - 1, bl)
        keep_lo[:, lv] = torch.where(infg, lo, -2 ** 31).amax(1)
        keep_hi[:, lv] = torch.where(infg, bl + 1, 2 ** 31 - 1).amin(1)

    # df1's runs: one walk per pixel, all pixels at once
    runs_col, runs_coef, count = [], [], torch.zeros(rows, w1,
                                                     dtype=torch.long)
    bad = torch.zeros(rows, w1, dtype=torch.bool)
    for lv in range(nlev):
        w = widths[lv]
        pend = torch.full((rows, w1), -1, dtype=torch.long)
        coef = torch.zeros(rows, w1)
        for k in range(kk):
            q = lv * kk + k
            bq = b[..., q]
            bad |= (bq == NAN_TAP) & (w > 0)
            reach = torch.where(bq >= FAR, 0, (bq >= 0).long()
                                + (bq + 1 < w).long())
            bad |= torch.isinf(a0[..., q]) & (bq != NAN_TAP) & (reach < w)
            for d in (0, 1):
                j = bq + d
                ok = (bq < FAR) & (j >= 0) & (j < w)
                av = a1[..., q] if d else a0[..., q]
                same = ok & (j == pend)
                new = ok & (j != pend)
                emit = new & (pend >= 0)
                runs_col.append(torch.where(emit, offs[lv] + pend, -1))
                runs_coef.append(coef.clone())
                coef = torch.where(same, coef + av, coef)
                coef = torch.where(new, av, coef)
                pend = torch.where(new, j, pend)
        runs_col.append(torch.where(pend >= 0, offs[lv] + pend, -1))
        runs_coef.append(coef)
    cols = torch.stack(runs_col, -1)
    coefs = torch.stack(runs_coef, -1)
    # compact each pixel's emitted runs, in emission order
    keep = cols >= 0
    count = keep.sum(-1)
    order = torch.argsort((~keep).long(), dim=-1, stable=True)
    cols = torch.gather(cols, -1, order)
    coefs = torch.gather(coefs, -1, order)

    # df2's entries: per tile, chunk by chunk, from the column masks
    start = torch.zeros(rows, w2cat + 1, dtype=torch.long)
    hit_all, coef_all = [], []
    for p0 in range(0, w1, tile):
        np_ = min(tile, w1 - p0)
        hit = torch.zeros(rows, np_, w2cat, dtype=torch.bool)
        cf = torch.zeros(rows, np_, w2cat)
        for lv in range(nlev):
            w = widths[lv]
            for k in range(kk):
                q = lv * kk + k
                bq = b[:, p0:p0 + np_, q]
                for d in (0, 1):
                    j = bq + d
                    ok = (bq < FAR) & (j >= 0) & (j < w)
                    col = (offs[lv] + j.clamp(0, max(w - 1, 0)))[..., None]
                    av = (a1 if d else a0)[:, p0:p0 + np_, q]
                    old_hit = torch.gather(hit, 2, col)[..., 0]
                    old_cf = torch.gather(cf, 2, col)[..., 0]
                    val = torch.where(old_hit, old_cf + av, av)
                    cf.scatter_(2, col,
                                torch.where(ok, val, old_cf)[..., None])
                    hit.scatter_(2, col, (ok | old_hit)[..., None])
        for cb in range(0, w2cat, chunk):  # masks -> counts
            start[:, cb + 1:cb + chunk + 1] += hit[:, :, cb:cb + chunk].sum(1)
        hit_all.append(hit)
        coef_all.append(cf)
    start = torch.cumsum(start, -1)
    cursor = start[:, :-1].clone()
    h = w1 * min(2 * lk, w2cat)
    ent_pix = torch.full((rows, h), -1, dtype=torch.long)
    ent_coef = torch.zeros(rows, h)
    rix = torch.arange(rows)[:, None, None]
    for t, (hit, cf) in enumerate(zip(hit_all, coef_all)):
        p0 = t * tile
        for cb in range(0, w2cat, chunk):
            hc = hit[:, :, cb:cb + chunk]
            rank = torch.cumsum(hc.long(), 1) - 1  # pixels below in the mask
            at = cursor[:, None, cb:cb + chunk] + rank
            pix = (p0 + torch.arange(hc.shape[1]))[None, :, None].expand_as(at)
            r_, at_, pix_ = rix.expand_as(at)[hc], at[hc], pix[hc]
            ent_pix[r_, at_] = pix_
            ent_coef[r_, at_] = cf[:, :, cb:cb + chunk][hc]
            cursor[:, cb:cb + chunk] += hc.sum(1)
    return dict(cols=cols, coefs=coefs, count=count, bad=bad, start=start,
                ent_pix=ent_pix, ent_coef=ent_coef, poison=poison,
                keep_lo=keep_lo, keep_hi=keep_hi)


def sums(f1, f2, widths, ls):
    """The sums kernel: per (row, channel slice) block, df1 one fmaf chain
    over each pixel's runs and df2 over each column's entries."""
    rows, w1, c = f1.shape
    w2cat = f2.shape[1]
    scale = torch.tensor(1.0 / float(c) ** 0.5)
    df1 = torch.empty_like(f1)
    df2 = torch.empty_like(f2)
    cs = slice_width()
    rix = torch.arange(rows)
    nlev = len(widths)
    offs = [sum(widths[:i]) for i in range(nlev)]
    lvl_of = torch.repeat_interleave(torch.arange(nlev),
                                     torch.tensor(widths))
    jl = torch.arange(w2cat) - torch.tensor(offs)[lvl_of]
    for c0 in range(0, c, cs):
        sl = slice(c0, c0 + cs)
        acc = torch.zeros(rows, w1, cs)
        for r in range(int(ls["count"].max()) if ls["count"].numel() else 0):
            live = r < ls["count"]
            col = torch.where(live, ls["cols"][..., r], 0)
            s = (ls["coefs"][..., r] * scale)[..., None]
            v = torch.gather(f2[:, :, sl], 1,
                             col[..., None].expand(-1, -1, cs))
            acc = torch.where(live[..., None], _fma(s, v, acc), acc)
        df1[:, :, sl] = torch.where(ls["bad"][..., None], torch.nan, acc)
        acc = torch.zeros(rows, w2cat, cs)
        start = ls["start"]
        n = start[:, 1:] - start[:, :-1]
        for e in range(int(n.max()) if n.numel() else 0):
            live = e < n
            at = torch.where(live, start[:, :-1] + e, 0)
            pix = ls["ent_pix"][rix[:, None], at].clamp_min(0)
            s = (ls["ent_coef"][rix[:, None], at] * scale)[..., None]
            v = torch.gather(f1[:, :, sl], 1, pix[..., None].expand(-1, -1,
                                                                     cs))
            acc = torch.where(live[..., None], _fma(s, v, acc), acc)
        bad = (ls["poison"][:, lvl_of] | (jl < ls["keep_lo"][:, lvl_of])
               | (jl > ls["keep_hi"][:, lvl_of]))
        df2[:, :, sl] = torch.where(bad[..., None], torch.nan, acc)
    return df1, df2


def emulate(f1, f2, taps, g, widths, tile=None, chunk=None):
    """``alt_corr_taps_backward`` as the two kernels compute it."""
    return sums(f1, f2, widths, lists(taps, g, widths, tile, chunk))


def first_form(f1, f2, taps, g, widths):
    """The first form's order: df1 one walk of the taps per pixel
    (consecutive equal columns merged), df2 one scan of the row's pixels
    per column, each pixel's coefficient summed over its taps in order, an
    infinite g's tap putting NaN on every column it misses."""
    rows, w1, lk = taps.shape
    nlev = len(widths)
    kk = lk // nlev
    c = f1.shape[-1]
    scale = torch.tensor(1.0 / float(c) ** 0.5)
    b, a0, a1 = tables(taps, g, widths)
    offs = [sum(widths[:i]) for i in range(nlev)]
    df1 = torch.zeros_like(f1)
    df2 = torch.zeros_like(f2)
    for n in range(rows):
        for i in range(w1):
            acc = torch.zeros(c)
            bad = False
            for lv in range(nlev):
                w = widths[lv]
                pend, coef = -1, None
                for k in range(kk):
                    q = lv * kk + k
                    bq = int(b[n, i, q])
                    if bq == NAN_TAP:
                        bad = bad or w > 0
                        continue
                    reach = 0 if bq == FAR else (bq >= 0) + (bq + 1 < w)
                    if torch.isinf(a0[n, i, q]) and reach < w:
                        bad = True
                    if bq == FAR:
                        continue
                    for d in (0, 1):
                        j = bq + d
                        if j < 0 or j >= w:
                            continue
                        av = (a1 if d else a0)[n, i, q]
                        if j == pend:
                            coef = coef + av
                        else:
                            if pend >= 0:
                                acc = _fma(coef * scale,
                                           f2[n, offs[lv] + pend], acc)
                            pend, coef = j, av
                if pend >= 0:
                    acc = _fma(coef * scale, f2[n, offs[lv] + pend], acc)
            df1[n, i] = torch.nan if bad else acc
        for lv in range(nlev):
            w = widths[lv]
            sel = slice(lv * kk, (lv + 1) * kk)
            poisoned = bool((b[n, :, sel] == NAN_TAP).any()) and w > 0
            for jl in range(w):
                acc = torch.zeros(c)
                for i in range(w1):
                    coef, hit = None, False
                    for k in range(kk):
                        q = lv * kk + k
                        bq = int(b[n, i, q])
                        if bq < FAR and (bq == jl or bq + 1 == jl):
                            av = a0[n, i, q] if bq == jl else a1[n, i, q]
                            coef = coef + av if hit else av
                            hit = True
                        elif bq != NAN_TAP and torch.isinf(a0[n, i, q]):
                            coef, hit = torch.tensor(torch.nan), True
                            break
                    if hit:
                        acc = _fma(coef * scale, f1[n, i], acc)
                df2[n, offs[lv] + jl] = torch.nan if poisoned else acc
    return df1, df2


# ---------------------------------------------------------------- inputs

def _inputs(case, seed=3):
    """(f1, f2cat, taps, g, widths) of one case, fp32 tensors (rows, W1,
    C), (rows, sum(widths), C), (rows, W1, L*K).  Taps mix the radial
    pattern around a random centre, random reals in [-3, w + 3], exact
    integers, taps at -1, 0, w - 1 and w, far and infinite taps."""
    rows, w1, widths, kk, c = {
        "scattered": (3, 20, (20, 10, 5, 2), 9, 128),
        "recipe_row": (2, 180, (180, 90, 45, 22), 9, 128),
        "poison": (3, 20, (20, 10, 5, 2), 9, 128),
        "inf_mix": (3, 12, (12, 6, 3, 1), 9, 128),
        "w0w1": (2, 20, (20, 0, 1, 5), 7, 128),
        "ragged": (2, 70, (70, 35, 17, 8), 9, 128),
        "c384": (2, 20, (20, 10, 5, 2), 5, 384),
        "c640": (2, 20, (20, 10, 5, 2), 9, 640),
        "many_taps": (1, 3, (64,), 19000, 128),
    }[case]
    rng = np.random.default_rng(seed)
    f1 = rng.normal(size=(rows, w1, c)).astype(np.float32)
    f2 = rng.normal(size=(rows, sum(widths), c)).astype(np.float32)
    cols = []
    for w in widths:
        t = rng.uniform(-3.0, w + 3.0, (rows, w1, kk))
        t[..., 0] = np.floor(t[..., 0])
        if kk >= 4:
            t[..., 1:4] = (rng.uniform(-2.0, w + 1.0, (rows, w1, 1))
                           + np.arange(-1, 2))
        m = min(4, w1)
        t[0, :m, -1] = [-1e6, 1e6, np.inf, -np.inf][:m]
        t[-1, :m, -1] = [-1.0, 0.0, w - 1.0, float(w)][:m]
        cols.append(t)
    taps = np.concatenate(cols, axis=-1).astype(np.float32)
    g = rng.normal(size=taps.shape).astype(np.float32)
    if case == "poison":
        taps[1, 7, 2] = np.nan          # level 0 of row 1
        g[2, 3, 9 + 4] = np.nan         # level 1 of row 2
        taps[0, 5, 18 + 3] = 2.5        # level 2 of row 0: columns 2, 3
        g[0, 5, 18 + 3] = np.inf
        g[0, 8, 27 + 1] = -np.inf       # level 3 of row 0
    if case == "inf_mix":
        taps[0, 2, 27:36] = 0.5         # every tap weights the 1-wide level
        g[0, 2, 31] = np.inf            # so df1 stays +-inf there
        taps[1, 3:5, 4] = [3.25, 4.25]  # two infinite taps sharing columns
        g[1, 3, 4] = np.inf
        g[1, 4, 4] = np.inf
        taps[2, 6, 2] = 6.0             # weight 1 on column 6, 0 on 7
        g[2, 6, 2] = np.inf
    return (torch.from_numpy(f1), torch.from_numpy(f2),
            torch.from_numpy(taps), torch.from_numpy(g), widths)


CASES = ["scattered", "recipe_row", "poison", "inf_mix", "w0w1", "ragged",
         "c384", "c640", "many_taps"]


def _nonfinite_matches(a, w):
    """NaN exactly where the reference is NaN, the same +-inf where it is
    infinite."""
    inf = w.isinf()
    return (torch.equal(a.isnan(), w.isnan()) and torch.equal(a.isinf(), inf)
            and torch.equal(a[inf], w[inf]))


def _same_bits(a, b):
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(7.0).view(torch.int32),
                            b.nan_to_num(7.0).view(torch.int32)))


@pytest.mark.parametrize("case", CASES)
def test_emulation_within_tol_of_plain(case):
    """The emulated kernels against ``alt_corr_taps_backward_plain``: NaN
    and +-inf exactly where plain has them (a NaN tap or g poisons its
    pixel's df1 and its level in the row; an infinite g gives the two
    columns its tap weights +-inf and the level's others NaN), within
    ``BACKWARD_TOL`` of max(1, |plain|) elsewhere."""
    f1, f2, taps, g, widths = _inputs(case)
    got = emulate(f1, f2, taps, g, widths)
    want = talt.alt_corr_taps_backward_plain(f1, f2, taps, g, widths)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        assert _nonfinite_matches(a, w)
        ok = torch.isfinite(w)
        scale = max(1.0, float(w[ok].abs().max()))
        assert float((a[ok] - w[ok]).abs().max()) <= BACKWARD_TOL * scale
    if case == "poison":
        df1, df2 = got
        assert bool(df1[1, 7].isnan().all()) and bool(df2[1, :20].isnan()
                                                      .all())
        assert bool(df2[2, 20:30].isnan().all())
        assert not bool(df2[1, 20:].isnan().any())
        # the infinite g's tap weights columns 2 and 3 of level 2 (+-inf
        # there, or NaN where two infinities meet); the level's others NaN
        assert bool(df2[0, 32:34].isinf().any()) and bool(
            (df2[0, 32:34].isinf() | df2[0, 32:34].isnan()).all())
        assert bool(df2[0, [30, 31, 34]].isnan().all())
    if case == "inf_mix":
        assert bool(got[0][0, 2].isinf().all())   # 1-wide level: df1 +-inf
        assert bool(got[1][2, 6].isinf().all())   # weight 1: +-inf
        assert bool(got[1][2, 7].isnan().all())   # weight 0: inf * 0


@pytest.mark.parametrize("case", ["scattered", "poison", "inf_mix", "w0w1",
                                  "ragged"])
def test_lists_keep_the_first_form_order(case):
    """The kernels keep the first form's summation order: the emulation
    equals, bit for bit, one walk of the taps per pixel (df1) and one scan
    of the row's pixels per column (df2), non-finite values included (so
    the two trees' card digests match, ``scripts/ab_taps.py``)."""
    f1, f2, taps, g, widths = _inputs(case)
    if case == "ragged":
        f1, f2, taps, g = f1[:1], f2[:1], taps[:1], g[:1]
    got = emulate(f1, f2, taps, g, widths)
    want = first_form(f1, f2, taps, g, widths)
    for a, w in zip(got, want):
        assert _same_bits(a, w)


def test_tiles_and_chunks_leave_every_bit():
    """Tiles of 4 pixels and chunks of 32 columns (a row whose tables or
    masks outgrow shared memory) give the one-tile bits: a column's chain
    resumes in the next tile where it stopped."""
    f1, f2, taps, g, widths = _inputs("ragged")
    whole = emulate(f1, f2, taps, g, widths)
    tiled = emulate(f1, f2, taps, g, widths, tile=4, chunk=32)
    for a, b in zip(whole, tiled):
        assert _same_bits(a, b)


@pytest.mark.parametrize("batch", [1, 2])
def test_batches_leave_every_bit(batch):
    """Rows run in batches sharing one workspace give the bits of one
    launch over every row: a row's lists and sums read only that row."""
    f1, f2, taps, g, widths = _inputs("poison")
    whole = emulate(f1, f2, taps, g, widths)
    parts = [emulate(f1[r:r + batch], f2[r:r + batch], taps[r:r + batch],
                     g[r:r + batch], widths)
             for r in range(0, taps.shape[0], batch)]
    for i, a in enumerate(whole):
        assert _same_bits(a, torch.cat([p[i] for p in parts]))


def test_slices_leave_every_bit(monkeypatch):
    """128-channel and 32-channel slices give equal bits: each channel's
    chain is its own."""
    f1, f2, taps, g, widths = _inputs("c384")
    wide = emulate(f1, f2, taps, g, widths)
    monkeypatch.setattr(sys.modules[__name__], "slice_width", lambda: 32)
    narrow = emulate(f1, f2, taps, g, widths)
    for a, b in zip(wide, narrow):
        assert _same_bits(a, b)


@pytest.mark.parametrize("case", ["scattered", "poison", "w0w1", "ragged",
                                  "c384"])
def test_emulation_matches_jax(case):
    """The emulated gradients against ``jax.grad`` through
    ``pallas_alt_pyramid_flat`` (the custom VJP ``_make_alt_pyr``, its
    backward kernel in interpret mode): within 1e-4 of the largest
    gradient, NaN where JAX has NaN, as in
    ``test_torch_port_lookup_norm.py``.  Infinite cotangents stay out:
    the TPU kernel's lane padding turns some of the dense hat's +-inf into
    NaN (``tests/test_torch_port_alt_bwd.py``)."""
    f1, f2, taps, g, widths = _inputs(case)
    g = torch.where(g.isinf(), torch.ones_like(g), g)
    rows, w1, lk = taps.shape
    b, h = 1, rows
    cot = g.numpy()

    def jloss(a, bb):
        out = jalt.pallas_alt_pyramid_flat(
            jalt.preflatten_fmap1(a), jalt.preflatten_fmap2(bb),
            jnp.asarray(taps.numpy().reshape(b, h, w1, lk)), widths)
        return jnp.sum(out * cot.reshape(b, h, w1, lk))

    want = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(f1.numpy().reshape(b, h, w1, -1)),
        jnp.asarray(f2.numpy().reshape(b, h, f2.shape[1], -1)))
    got = emulate(f1, f2, taps, g, widths)
    for a, w in zip(got, want):
        w = np.asarray(w).reshape(a.shape)
        a = a.numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(w))
        ok = ~np.isnan(w)
        scale = max(1.0, float(np.abs(w[ok]).max()))
        assert float(np.abs(a[ok] - w[ok]).max()) <= BACKWARD_TOL * scale
