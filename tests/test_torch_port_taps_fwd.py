"""Row 3 (``csrc/alt_corr_taps.cu``, the lookup at caller-given taps): the
kernel's partition of the work and its summation order, on the CPU.

The kernel runs only on the card.  These tests hold an emulation of it: a
block per (image row, tile of kTilePix pixels, group of levels), kTeam
threads a pixel; per level each pixel's distinct columns (the union of
floor(t) and floor(t) + 1 over its taps, inside the level) ranked in
ascending order; the tile's span of columns staged in windows of at most
kMaxSpan columns, a window's slots taken in rounds of kTeam * kSlots (as
many as its most columns a pixel need; a window no pixel's columns meet is
skipped), slot s of a pixel going to thread (s - first slot of the
window) mod kTeam;
each dot one fmaf chain over 128-byte channel chunks, the chunk's eight
16-byte slots read in the order (step + lane) mod 8 of the thread's lane
(threadIdx mod 8); the dot scaled once; each tap the plain version's two
products and sum of its columns' dots.  Where a tile's dots would outgrow
shared memory the call takes the general form, whose dots end in a
shuffle tree over 32 lanes; that order is emulated too.  The emulation is
held against the plain version (``alt_corr_taps_plain``) within
``chip_smoke.TAPS_TOL`` (fp32 out) or one bf16 ulp (bf16 out), NaN
exactly where plain has it, and against the JAX package's
``pallas_alt_pyramid_flat`` (its ``_alt_pyr_fwd_kernel`` in interpret
mode) at the tolerances of ``tests/test_torch_port_lookup_norm.py``.
Inputs are made with numpy from a seed.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raftstereo_tpu.ops import pallas_alt as jalt
from raftstereo_tpu_torch.ops import _build
from raftstereo_tpu_torch.ops import alt_lookup as talt
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse

# chip_smoke.py's TAPS_TOL: fp32 dots of length C summed in another order
# (and the lerp weight against the dense hat's), relative to max(1, |ref|)
TAPS_TOL = 1e-5
BF16_ULP = 2.0 ** -7


# ------------------------------------------------------------- geometry

def _source():
    return _build.source_text("alt_corr_taps")


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _source())
               .group(1))


def geometry():
    """(kTilePix, kTeam, kSlots, kRowBytes, kMaxSpan) from the source,
    with the thread mapping and the lane rotation it relies on."""
    src = _source()
    assert ("const int pl = threadIdx.x / kTeam, q = threadIdx.x % kTeam;"
            in src)
    assert "const int rot = threadIdx.x & 7;" in src
    assert "const int qo = ((s + rot) & 7) * 16;" in src
    assert "s0 = r0 + cur.r * kTeam * kSlots + q;" in src
    assert ("const int rounds = (most(p) + kTeam * kSlots - 1) / "
            "(kTeam * kSlots);" in src)
    return tuple(_const(n) for n in ("kTilePix", "kTeam", "kSlots",
                                     "kRowBytes", "kMaxSpan"))


def groups(widths):
    """Level groups, one block each: consecutive levels whose widths sum
    to at most the widest (the source's rule)."""
    widest, out, total = max(widths), [], 0
    for lvl, w in enumerate(widths):
        if lvl == 0 or total + w > widest:
            out.append(lvl)
            total = 0
        total += w
    return out + [len(widths)]


def tiled(widths, kk):
    """Whether the tiled form takes the call: no level wider than
    kMaxWindows windows of kMaxSpan columns, and its shared memory (two
    stages of the span, each pixel's masks, their prefix counts, one
    level's dots and each window's most columns a pixel) within the
    block's limit."""
    tile, _, _, row_bytes, max_span = geometry()
    words = sum((w + 31) // 32 for w in widths)
    dmax = max(min(2 * kk, w) for w in widths)
    span = max(1, min(max(widths), max_span))
    nwin = sum(-(-w // span) for w in widths)
    smem = (2 * span * row_bytes + 4 * tile * (2 * words + len(widths) + dmax)
            + 4 * nwin)
    assert "if (smem > kMaxSmem - 128)" in _source()
    assert "if (a.lv.width[l] > kMaxWindows * kMaxSpan) return 1;" in _source()
    return (smem <= _const("kMaxSmem") - 128
            and max(widths) <= _const("kMaxWindows") * max_span)


def test_geometry_and_groups():
    """64-pixel tiles, 4 threads a pixel, 5 dots each at once; a halving
    pyramid splits into level 0 and levels 1..L-1; the smoke's shapes and
    the evaluation pyramid take the tiled form; a 2000-wide level with 600
    taps (its dots), a 1000-wide level and the full-width pyramid (more
    than 3 windows a level) the general one."""
    assert geometry() == (64, 4, 5, 128, 256)
    assert groups((240, 120, 60, 30)) == [0, 1, 4]
    assert groups((180, 90, 45, 22)) == [0, 1, 4]
    assert groups((17,)) == [0, 1]
    assert groups((64, 64, 64)) == [0, 1, 2, 3]
    assert tiled((240, 120, 60, 30), 9) and tiled((180, 90, 45, 22), 9)
    assert tiled((312, 156, 78, 39), 9) and tiled((600, 300), 150)
    assert not tiled((2000,), 600)
    assert not tiled((1000,), 100) and not tiled((1248, 624, 312, 156), 9)


# ------------------------------------------------------------- emulation

def _fma(a, b, c):
    """fmaf in fp32 (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _dots_rotated(f1v, f2v, rot, v):
    """Dots of paired rows (n, C) in the tiled form's order: 128-byte
    chunks ascending, slot (s + rot) mod 8 at step s, its v values in
    order; fp32 FMAs from 0."""
    n, c = f1v.shape
    chunk = 8 * v
    acc = torch.zeros(n)
    for c0 in range(0, c, chunk):
        for s in range(8):
            slot = (s + rot) % 8
            for e in range(v):
                ch = c0 + slot * v + e
                acc = _fma(f1v[:, ch], f2v[:, ch], acc)
    return acc


def _dots_tree(f1v, f2v, v):
    """Dots in the general form's order: lane i sums channels i*v .. i*v +
    v - 1 of each 32*v-channel chunk, chunks ascending; the 32 lane sums
    then meet in an xor-shuffle tree (16, 8, 4, 2, 1); lane 0's sum."""
    n, c = f1v.shape
    chunk = 32 * v
    lanes = torch.zeros(32, n)
    for lane in range(32):
        acc = torch.zeros(n)
        for c0 in range(0, c, chunk):
            for e in range(v):
                ch = c0 + lane * v + e
                acc = _fma(f1v[:, ch], f2v[:, ch], acc)
        lanes[lane] = acc
    for m in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[torch.arange(32) ^ m]
    return lanes[0]


def emulate(f1, f2, taps, widths, out_dtype=torch.float32):
    """``alt_corr_taps`` as the kernel computes it: f1 (rows, W1, C), f2
    (rows, sum(widths), C) fp32 or bf16, taps (rows, W1, L*K)."""
    tile, team, slots, row_bytes, max_span = geometry()
    rows, w1, c = f1.shape
    lk = taps.shape[-1]
    nlev = len(widths)
    kk = lk // nlev
    v = row_bytes // 8 // f1.element_size()   # values per 16-byte slot
    f1v, f2v = f1.float(), f2.float()
    scale = torch.tensor(1.0 / float(c) ** 0.5)
    offs = [sum(widths[:i]) for i in range(nlev)]
    span = max(1, min(max(widths), max_span))
    general = not tiled(widths, kk)
    # every dot a tap needs: (row, pixel, level, column) -> the lane
    # rotation of the thread that sums it
    need = {}
    for n in range(rows):
        for p0 in range(0, w1, tile):
            np_ = min(tile, w1 - p0)
            for lvl in range(nlev):
                w = widths[lvl]
                t = taps[n, p0:p0 + np_, lvl * kk:(lvl + 1) * kk]
                ok = (t > -1.0) & (t < float(w))
                b0 = torch.floor(torch.where(ok, t, torch.zeros_like(t)))
                cols = []
                for i in range(np_):
                    js = set()
                    for j in b0[i][ok[i]].long().tolist():
                        js.update(x for x in (j, j + 1) if 0 <= x < w)
                    cols.append(sorted(js))
                used = [x for cs in cols for x in cs]
                if not used:
                    continue
                lo, hi = min(used), max(used)
                for a0 in range(lo, hi + 1, span):
                    wn = min(span, hi + 1 - a0)
                    ranks = [(sum(x < a0 for x in cs),
                              sum(x < min(a0 + wn, w) for x in cs))
                             for cs in cols]
                    rounds = -(-max(r1 - r0 for r0, r1 in ranks)
                               // (team * slots))
                    for i, cs in enumerate(cols):
                        r0, r1 = ranks[i]
                        for r in range(rounds):
                            for q in range(team):
                                for g in range(slots):
                                    s = r0 + r * team * slots + q + team * g
                                    if s < r1:
                                        need[(n, p0 + i, lvl, cs[s])] = (
                                            (i * team + q) % 8)
    dotv = torch.zeros(rows, w1, sum(widths))
    if need:
        keys = list(need)
        ix = torch.tensor([[k[0], k[1], offs[k[2]] + k[3]] for k in keys])
        rot = torch.tensor([need[k] for k in keys])
        a = f1v[ix[:, 0], ix[:, 1]]
        b = f2v[ix[:, 0], ix[:, 2]]
        vals = torch.empty(len(keys))
        if general:
            vals = _dots_tree(a, b, 16 // f1.element_size())
        else:
            for r in range(8):
                sel = rot == r
                if bool(sel.any()):
                    vals[sel] = _dots_rotated(a[sel], b[sel], r, v)
        dotv[ix[:, 0], ix[:, 1], ix[:, 2]] = vals * scale
    out = torch.zeros(taps.shape)
    for lvl in range(nlev):
        w = widths[lvl]
        t = taps[..., lvl * kk:(lvl + 1) * kk]
        ok = (t > -1.0) & (t < float(w))
        b0 = torch.floor(torch.where(ok, t, torch.zeros_like(t)))
        f = t - b0
        j0 = b0.long()
        dl = dotv[..., offs[lvl]:offs[lvl] + w]
        if w == 0:
            continue
        v0 = torch.gather(dl, 2, j0.clamp(0, w - 1))
        v1 = torch.gather(dl, 2, (j0 + 1).clamp(0, w - 1))
        v0 = torch.where(ok & (j0 >= 0), v0, torch.zeros_like(v0))
        v1 = torch.where(ok & (j0 + 1 < w), v1, torch.zeros_like(v1))
        r = v0 * (1.0 - f) + v1 * f
        r = torch.where(ok, r, torch.zeros_like(r))
        out[..., lvl * kk:(lvl + 1) * kk] = torch.where(
            t.isnan(), torch.full_like(r, float("nan")), r)
    return out.to(out_dtype)


# ---------------------------------------------------------------- inputs

CASES = {
    # name: (rows, W1, widths, taps per level, C, fmap dtype, out dtype)
    "scattered": (3, 20, (20, 10, 5, 2), 9, 128, "float32", "float32"),
    "ragged_rows": (2, 70, (70, 35, 17, 8), 9, 128, "float32", "float32"),
    "smooth": (2, 70, (70, 35, 17, 8), 9, 128, "float32", "float32"),
    "w0w1": (2, 20, (20, 0, 1, 5), 7, 128, "float32", "float32"),
    "c384": (2, 20, (20, 10, 5, 2), 5, 384, "float32", "float32"),
    "c640": (2, 20, (20, 10, 5, 2), 9, 640, "float32", "float32"),
    "bf16_in": (3, 20, (20, 10, 5, 2), 9, 256, "bfloat16", "float32"),
    "bf16_in_out": (3, 20, (20, 10, 5, 2), 9, 256, "bfloat16", "bfloat16"),
    "wide_level": (1, 70, (300, 150), 9, 128, "float32", "float32"),
    "many_taps": (1, 6, (100, 50), 300, 128, "float32", "float32"),
    "general": (1, 3, (700,), 400, 128, "float32", "float32"),
}


def _inputs(case, seed=5):
    """f1 (rows, W1, C), f2cat, taps (rows, W1, L*K) as tensors; taps mix
    the radial pattern around a centre (random, or a slowly varying
    disparity for ``smooth``), random reals in [-3, w + 3], integers,
    taps at -1, 0, w - 1 and w, far and infinite taps, and one NaN."""
    rows, w1, widths, kk, c, dt, odt = CASES[case]
    rng = np.random.default_rng(seed)
    f1 = rng.normal(size=(rows, w1, c)).astype(np.float32)
    f2 = rng.normal(size=(rows, sum(widths), c)).astype(np.float32)
    cols = []
    xx = np.arange(w1)
    for w in widths:
        t = rng.uniform(-3.0, w + 3.0, (rows, w1, kk))
        if case == "smooth":
            centre = ((xx - 8.0 - 6.0 * np.sin(xx / 9.0)) * w / w1)[None, :,
                                                                    None]
            t = centre + rng.uniform(-4.0, 4.0, (rows, w1, kk))
        else:
            centre = rng.uniform(-2.0, w + 1.0, (rows, w1, 1))
        m = min(5, kk)
        t[..., :m] = centre + np.arange(-2, m - 2)
        t[..., -2] = np.floor(t[..., -2])
        k4 = min(4, w1)
        t[0, :k4, -1] = [-1e6, 1e6, np.inf, -np.inf][:k4]
        if w1 >= 8:  # at -1, 0, w - 1 and w, beside the far ones
            t[-1, 4:8, -1] = [-1.0, 0.0, w - 1.0, float(w)]
        cols.append(t)
    taps = np.concatenate(cols, axis=-1).astype(np.float32)
    taps[rows - 1, w1 - 1, 2] = np.nan
    tdt = getattr(torch, dt)
    return (torch.from_numpy(f1).to(tdt), torch.from_numpy(f2).to(tdt),
            torch.from_numpy(taps), widths, getattr(torch, odt))


def _check(got, want, out_dtype):
    assert got.dtype == want.dtype == out_dtype
    got, want = got.float(), want.float()
    assert torch.equal(got.isnan(), want.isnan())
    ok = ~want.isnan()
    rel = BF16_ULP if out_dtype == torch.bfloat16 else TAPS_TOL
    err = ((got[ok] - want[ok]).abs() / want[ok].abs().clamp_min(1.0)).max()
    assert float(err) <= rel, float(err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulation_within_tol_of_plain(case):
    """The emulated kernel against ``alt_corr_taps_plain``: NaN only at the
    NaN tap (of a level with columns), 0 at taps outside their level,
    within ``TAPS_TOL`` (fp32 out) or one bf16 ulp (bf16 out) of max(1,
    |plain|) elsewhere."""
    f1, f2, taps, widths, odt = _inputs(case)
    got = emulate(f1, f2, taps, widths, odt)
    want = talt.alt_corr_taps_plain(f1, f2, taps, widths, odt)
    _check(got, want, odt)
    assert int(got.isnan().sum()) == 1
    kk = taps.shape[-1] // len(widths)
    assert (got[0, :2, kk - 1::kk] == 0).all()  # taps at -1e6, 1e6
    assert tiled(widths, kk) == (case != "general")


@pytest.mark.parametrize("case", ["scattered", "smooth", "w0w1", "c384",
                                  "bf16_in", "bf16_in_out", "wide_level"])
def test_emulation_matches_jax(case):
    """The emulated kernel against the JAX package's interpret-mode
    ``pallas_alt_pyramid_flat``: within 1e-5 of max(1, |ref|) (fp32 out)
    or one bf16 ulp (bf16 out), NaN where JAX has NaN."""
    f1, f2, taps, widths, odt = _inputs(case)
    rows, w1, lk = taps.shape
    jdt = jnp.float32 if f1.dtype == torch.float32 else jnp.bfloat16
    want = jalt.pallas_alt_pyramid_flat(
        jalt.preflatten_fmap1(jnp.asarray(f1.float().numpy(), jdt)
                              .reshape(1, rows, w1, -1)),
        jalt.preflatten_fmap2(jnp.asarray(f2.float().numpy(), jdt)
                              .reshape(1, rows, f2.shape[1], -1)),
        jnp.asarray(taps.numpy().reshape(1, rows, w1, lk)), widths,
        out_dtype=jnp.float32 if odt == torch.float32 else jnp.bfloat16)
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32))).reshape(
        taps.shape).to(odt)
    _check(emulate(f1, f2, taps, widths, odt), want, odt)


def test_rotation_changes_only_the_order():
    """The lane rotation permutes a dot's channel order and nothing else:
    the eight rotations of one dot agree within fp32 rounding, and the
    general form's tree too."""
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.normal(size=(4, 256)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(4, 256)).astype(np.float32))
    exact = (a.double() * b.double()).sum(-1)
    for r in range(8):
        got = _dots_rotated(a, b, r, 4).double()
        assert float((got - exact).abs().max()) <= 1e-5 * 16
    assert float((_dots_tree(a, b, 4).double() - exact).abs().max()) <= 1e-4
