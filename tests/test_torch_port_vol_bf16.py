"""The bf16 forms of rows 5 and 7 (``csrc/corr_vol.cu`` over a bf16
volume pyramid, ``csrc/int8_volume.cu`` with a bf16 volume) and the bf16
``pallas`` state around them, against the JAX package on the CPU.

Inputs are made with numpy from a seed and passed to both packages; the
JAX side runs its Pallas kernels in interpret mode (automatic off the
TPU).  Bits are compared as uint16 (bf16) or int32 (fp32) views:

* row 7's bf16 plain version against ``pallas_int8_corr_volume(...,
  out_dtype=bfloat16)`` and ``quant_corr_volume(..., dtype=bfloat16)``:
  bitwise (the exact integer sum, the fp32 epilogue, one rounding);
* the bf16 pyramid against ``build_corr_pyramid`` on the same bf16
  volume: bitwise (each level pooled from the previous bf16 one, fp32
  sum, one rounding), and a form that pools in fp32 first differs;
* row 5's bf16 plain version against the JAX ``pallas`` lookup
  (``_lookup_kernel``, interpret mode) over the same bf16 volume pyramid:
  bitwise, NaN where the coordinate is NaN;
* the kernel's bf16 window (16-byte chunks of 8 columns, the shift
  undone by a barrel shifter) emulated in Python from the source's
  constants: every column a tap reads is the column it names.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse

from raftstereo_tpu.ops import corr as jcorr
from raftstereo_tpu.ops import quant as jquant
from raftstereo_tpu_torch.ops import _build, cuda_vol, quant
from raftstereo_tpu_torch.ops.corr import (CorrState, build_corr_pyramid,
                                           build_corr_state,
                                           build_corr_volume, corr_lookup)

BF = torch.bfloat16


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _bits(a) -> np.ndarray:
    """The raw bits of a bf16 (uint16) or fp32 (uint32) array or tensor."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.view(torch.int16).numpy().view(np.uint16)
                if a.dtype == BF else a.numpy().view(np.uint32))
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _features(rng, b, h, w, c=256):
    return (rng.normal(size=(b, h, w, c)).astype(np.float32),
            rng.normal(size=(b, h, w, c)).astype(np.float32))


def _coords(rng, b, h, w):
    """Level-0 x with taps past both edges, a NaN pixel, integers,
    half-integers and values just below an integer."""
    x = (np.arange(w, dtype=np.float32)
         + rng.uniform(-w / 2, 6, (b, h, w)).astype(np.float32))
    x[0, 0, :4] = [-200.5, w + 200.25, 1e6, -3.5]
    x[0, 1] = np.arange(w) * 0.5 - 3.0
    x[-1, -1] = np.arange(w) - 1.9e-6
    x[-1, 0, -1] = np.nan
    return x


# ------------------------------------------------------------ row 7, bf16

def _quantized(c, w1, w2):
    rng = np.random.default_rng(c + w1)
    f1 = rng.normal(size=(2, 3, w1, c)).astype(np.float32)
    f2 = rng.normal(size=(2, 3, w2, c)).astype(np.float32) * 3
    f2[1, 1, 2] = 0.0  # a zero row: scale 1, codes 0
    return f1, f2, [np.array(a) for a in (
        *jquant.quantize_rows(jnp.asarray(f1)),
        *jquant.quantize_rows(jnp.asarray(f2)))]


@pytest.mark.parametrize("c,w1,w2", [(16, 7, 9), (256, 12, 20)])
@pytest.mark.parametrize("ref", ["pallas_kernel", "quant_xla",
                                 "quant_kernel"])
def test_int8_volume_bf16_plain_matches_jax(ref, c, w1, w2):
    """Row 7 with a bf16 volume: the plain version against the Pallas
    kernel with ``out_dtype=bfloat16`` (interpret mode), and the whole
    ``quant_corr_volume(..., dtype=bfloat16)`` (quantization included, its
    XLA and its kernel path) against the port's: every bit equal."""
    f1, f2, (q1, s1, q2, s2) = _quantized(c, w1, w2)
    if ref == "pallas_kernel":
        want = jquant.pallas_int8_corr_volume(
            *(jnp.asarray(a) for a in (q1, s1, q2, s2)),
            out_dtype=jnp.bfloat16)
        got = quant.int8_corr_volume(*(torch.from_numpy(a)
                                       for a in (q1, s1, q2, s2)),
                                     out_dtype=BF)
    else:
        want = jquant.quant_corr_volume(jnp.asarray(f1), jnp.asarray(f2),
                                        dtype=jnp.bfloat16,
                                        kernel=ref == "quant_kernel")
        got = quant.quant_corr_volume(_t(f1), _t(f2), BF)
    assert got.dtype == BF and got.shape == (2, 3, w1, w2)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (got[1, 1, :, 2] == 0).all()


def test_int8_volume_bf16_rounds_the_fp32_epilogue_once():
    """The bf16 volume is the fp32 volume rounded once to nearest even
    (not rounded per product), and a bf16 feature map is quantized from
    its widened values."""
    _, _, arrays = _quantized(48, 9, 11)
    args = [torch.from_numpy(a) for a in arrays]
    fp32 = quant.int8_corr_volume(*args)
    assert torch.equal(quant.int8_corr_volume(*args, out_dtype=BF),
                       fp32.to(BF))
    f = torch.randn(2, 3, 5, 32, generator=torch.Generator().manual_seed(0))
    qb, sb = quant.quantize_rows(f.to(BF))
    qf, sf = quant.quantize_rows(f.to(BF).float())
    assert torch.equal(qb, qf) and torch.equal(sb, sf)


# ----------------------------------------------------- the bf16 pyramid

@pytest.mark.parametrize("w2", [20, 37])
def test_corr_pyramid_bf16_matches_jax(w2):
    """``build_corr_pyramid`` on one bf16 volume in both packages: every
    level's bits equal.  Pooling in fp32 across levels and rounding each
    level after (the ``pallas_alt`` state's order) gives other bits, so
    the comparison can tell the two orders apart."""
    rng = np.random.default_rng(w2)
    vol = rng.normal(size=(2, 3, 9, w2)).astype(np.float32)
    vb = jnp.asarray(vol).astype(jnp.bfloat16)
    want = jcorr.build_corr_pyramid(vb, 4)
    got = build_corr_pyramid(_t(vol).to(BF), 4)
    assert [g.shape for g in got] == [tuple(p.shape) for p in want]
    for g, p in zip(got, want):
        assert g.dtype == BF
        np.testing.assert_array_equal(_bits(g), _bits(p))
    fp32_first = [p.to(BF) for p in build_corr_pyramid(_t(vol).to(BF)
                                                       .float(), 4)]
    assert any(not torch.equal(a, b) for a, b in zip(fp32_first, got))


@pytest.mark.parametrize("quant_volume", [False, True],
                         ids=["pallas", "corr_quant"])
def test_bf16_volume_state_matches_jax(quant_volume):
    """The whole bf16 ``pallas`` state from fp32 feature maps: the
    volume is the fp32 product (or the int8 epilogue) rounded once, then
    pooled level by level.  The int8 state is bitwise JAX's (exact
    integer sums); the fp32 product's sums run in another order than
    XLA's, so where its fp32 value differs the bf16 entry may sit one ulp
    away, and pooling carries that to the levels above: within one bf16
    ulp of max(1, |v|) and at least 99% of the entries equal."""
    rng = np.random.default_rng(8)
    f1, f2 = _features(rng, 2, 3, 21)
    levels = 4
    build = (jquant.quant_corr_volume if quant_volume
             else jcorr.build_corr_volume)
    want = jcorr.build_corr_pyramid(
        build(jnp.asarray(f1), jnp.asarray(f2), dtype=jnp.bfloat16), levels)
    st = build_corr_state(_t(f1), _t(f2), levels, "pallas", quant_volume,
                          BF)
    assert st.vcat.dtype == BF and st.widths == (21, 10, 5, 2)
    want = np.concatenate([np.asarray(p, np.float32) for p in want], -1)
    got = st.vcat.float().numpy()
    if quant_volume:
        np.testing.assert_array_equal(got, want)
        return
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= 2.0 ** -7 and (got == want).mean() >= 0.99


def test_corr_volume_bf16_is_one_rounding():
    f1, f2 = _features(np.random.default_rng(9), 1, 2, 7, c=64)
    v32 = build_corr_volume(_t(f1), _t(f2))
    assert torch.equal(build_corr_volume(_t(f1), _t(f2), BF), v32.to(BF))


# ---------------------------------------------------------- row 5, bf16

def _jax_pallas_state(f1, f2, levels):
    """JAX's bf16 ``pallas`` state and the port's real-width concat of
    the same bf16 values (the JAX levels are lane-padded, the rows and
    W1 padded to the kernel's blocks)."""
    state = jcorr.build_corr_state("pallas", jnp.asarray(f1),
                                   jnp.asarray(f2), levels,
                                   dtype=jnp.bfloat16)
    (vcat4,) = state
    b, h, w1 = f1.shape[:3]
    padded = jcorr._padded_level_widths(w1, levels)
    widths = [w1]
    for _ in range(levels - 1):
        widths.append(widths[-1] // 2)
    arr = np.asarray(vcat4)[:, :h, :w1]
    parts, off = [], 0
    for w, wp in zip(widths, padded):
        parts.append(arr[..., off:off + w])
        off += wp
    real = np.concatenate(parts, -1)
    port = torch.from_numpy(real.view(np.int16)).view(BF)
    return state, port, tuple(widths)


@pytest.mark.parametrize("levels,radius", [(4, 4), (2, 2), (3, 0)])
def test_vol_lookup_bf16_plain_matches_jax(levels, radius):
    """Row 5 over a bf16 volume pyramid: the plain version against the
    JAX ``pallas`` lookup (``_lookup_kernel`` in interpret mode, its
    dense hat sum over the widened bf16 row) on the same bf16 values:
    every bit equal, fp32 out, NaN where the coordinate is NaN.  The
    port's ``pallas`` lookup then casts to the compute dtype."""
    rng = np.random.default_rng(10 + radius)
    b, h, w = 2, 5, 20
    f1, f2 = _features(rng, b, h, w, c=32)
    x = _coords(rng, b, h, w)
    state, vcat, widths = _jax_pallas_state(f1, f2, levels)
    want = np.asarray(jcorr.corr_fn_from_state("pallas", state, levels,
                                               radius)(
        jnp.asarray(x)[..., None]))
    got = cuda_vol.vol_lookup(vcat, widths, _t(x), radius)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == x.shape + (levels * (2 * radius + 1),)
    nan = np.isnan(x)
    assert np.isnan(got.numpy()[nan]).all()
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_array_equal(_bits(torch.nan_to_num(got)),
                                  _bits(np.nan_to_num(want)))
    widened = cuda_vol.vol_lookup(vcat.float(), widths, _t(x), radius)
    assert torch.equal(torch.nan_to_num(widened), torch.nan_to_num(got))
    st = CorrState(None, None, widths, "pallas", vcat)
    feats = corr_lookup(st, _t(x), radius, BF)
    assert feats.dtype == BF and torch.equal(
        torch.nan_to_num(feats.float()), torch.nan_to_num(got.to(BF).float()))


def _window_geometry():
    """The kernel's window constants, from the source: the largest
    windowed radius, the window's columns over K, the chunk count
    formula and the barrel shifter's stages."""
    src = _build.source_text("corr_vol")
    max_r = int(re.search(r"constexpr int kMaxWindowRadius = (\d+);",
                          src).group(1))
    extra = int(re.search(r"constexpr int KW = KC \+ (\d+);", src).group(1))
    assert re.search(r"constexpr int NQ = \(KW \+ P - 1 \+ P - 1\) / P;",
                     src)
    assert re.search(r"constexpr int kPerChunk = 16 / \(int\)sizeof\(T\);",
                     src)
    stages = [int(b) for b in re.findall(
        r"shift_down<(\d+)>\(win, \(shift & \d+\) != 0\);", src)]
    return max_r, extra, stages


@pytest.mark.parametrize("elem_bytes", [2, 4], ids=["bf16", "fp32"])
def test_window_chunks_and_shift_read_the_named_columns(elem_bytes):
    """The kernel's window, emulated: for every radius up to
    ``kMaxWindowRadius``, window span (K-1..K+1 columns past f0), first
    column (from before the level to its last column), level width and
    alignment of the row, the 16-byte chunks it loads (vector loads
    inside the level, scalar ones at its edges, none past the window) and
    the shift undone (the select chain in fp32, the barrel shifter in
    bf16) leave column f0 + j at w[j] for every j the taps read, 0 where
    it lies outside the level, and read nothing outside the level."""
    max_r, extra, stages = _window_geometry()
    assert stages == [4, 2, 1]
    per = 16 // elem_bytes
    for radius in range(max_r + 1):
        k = 2 * radius + 1
        kw = k + extra
        nq = (kw + per - 1 + per - 1) // per
        for width in (1, 3, 9, 20):
            for c0 in range(1 - kw, width):
                for span in (k - 1, k, k + 1):
                    for align in range(per):
                        shift = (align + c0) % per
                        win = [0] * (per * nq)
                        for q in range(nq):
                            if per * q > shift + span:
                                break
                            ca = c0 - shift + per * q
                            vector = ca >= 0 and ca + per - 1 <= width - 1
                            for j in range(per):
                                col = ca + j
                                if vector or 0 <= col <= width - 1:
                                    assert 0 <= col <= width - 1
                                    win[per * q + j] = ("col", col)
                        if per == 4:
                            w = [win[j + shift] for j in range(kw)]
                        else:
                            for b in stages:
                                on = shift & b
                                for j in range(per * nq - b):
                                    win[j] = win[j + b] if on else win[j]
                            w = win[:kw]
                        for j in range(span + 1):
                            col = c0 + j
                            inside = 0 <= col <= width - 1
                            assert w[j] == (("col", col) if inside else 0), (
                                radius, width, c0, span, align, j)


def test_vol_wrappers_validate_dtypes_before_launch():
    """fp16 and float64 volumes, and an fp16 int8 volume, are refused
    (the kernels take fp32 or bf16)."""
    vcat = torch.zeros((1, 2, 8, 12), device="meta", dtype=torch.float16)
    x = torch.zeros((1, 2, 8), device="meta")
    with pytest.raises(ValueError):
        cuda_vol.vol_lookup(vcat, (8, 4), x, 2)
    with pytest.raises(ValueError):
        cuda_vol.vol_lookup(vcat.double(), (8, 4), x, 2)
    q = torch.zeros((1, 2, 8, 16), dtype=torch.int8)
    s = torch.ones((1, 2, 8))
    with pytest.raises(ValueError):
        quant.int8_corr_volume(q, s, q, s, out_dtype=torch.float16)
