"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: they skip without a GPU.  The machine with the
card has no JAX, so this file imports none and is run without the
repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""

import ctypes
import dataclasses
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig
from raftstereo_tpu_torch.device import fp32_numerics
from raftstereo_tpu_torch.ops import (_build, cuda_alt, cuda_encoder,
                                     cuda_gru, cuda_vol, quant)
from raftstereo_tpu_torch.ops.corr import build_corr_state

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("radius,levels", [(4, 4), (2, 2)])
def test_alt_corr_kernel_matches_plain(dev, radius, levels):
    """Hostile shapes: odd H, levels down to width 2, taps past both
    edges, NaN coordinates."""
    rng = np.random.default_rng(0)
    b, h, w = 2, 11, 20
    st = build_corr_state(_randn(rng, b, h, w, 256).to(dev),
                          _randn(rng, b, h, w, 256).to(dev), levels)
    x = np.arange(w, dtype=np.float32) + rng.uniform(-14, 10, (b, h, w))
    x[0, 0, :3] = [-200.5, w + 200.25, 1e6]
    x[1, 3, 4] = np.nan
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    before = cuda_alt.alt_corr.launches
    got = cuda_alt.alt_corr(st.fmap1, st.f2cat, st.widths, x, radius)
    assert cuda_alt.alt_corr.launches == before + 1
    want = cuda_alt.alt_corr_plain(st.fmap1, st.f2cat, st.widths, x, radius)
    torch.cuda.synchronize()
    assert torch.isnan(got[1, 3, 4]).all()
    # fp32 dots of length 256 summed in another order: ~1e-6 of O(1).
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5,
                               equal_nan=True)


def _lookup_field(dev, field, b, h, w, rng):
    """x (b, h, w) on the card: ``smooth``, a low-frequency sine of x and
    y in [-60, 0]; ``jump``, 8-pixel stripes near column 0 and near the
    row's end, so every 32-pixel tile's level-0 span exceeds the kernel's
    staging buffer and takes the wide-span path; ``diverged``, most
    windows past every level (a diverged disparity field) and every 13th
    pixel in range, so tiles stage the rows of a few pixels or none."""
    i = np.arange(w, dtype=np.float32)
    y = np.arange(b * h, dtype=np.float32).reshape(b, h, 1)
    if field == "smooth":
        x = i - 30.0 + 30.0 * np.sin(2 * np.pi * (i / 97.0 + y / 13.0))
    elif field == "diverged":
        x = i - 300.0 - 400.0 * rng.uniform(size=(b, h, w))
        x[..., ::13] = i[::13] - 20.0 * rng.uniform(size=(b, h, w))[..., ::13]
        x[:, 1:3] = -500.0        # whole rows past every level
    else:
        x = np.where((i // 8) % 2 == 1, w - 12.0, 0.0) + rng.uniform(
            0, 10, (b, h, w))
    return torch.from_numpy(x.astype(np.float32)).to(dev)


@pytest.mark.parametrize("field,dtype", [
    ("smooth", torch.float32), ("jump", torch.float32),
    ("diverged", torch.float32), ("smooth", torch.bfloat16),
    ("jump", torch.bfloat16), ("diverged", torch.bfloat16)],
    ids=["smooth", "wide_span", "diverged", "smooth_bf16", "wide_span_bf16",
         "diverged_bf16"])
def test_alt_corr_kernel_smooth_and_wide_span_fields(dev, field, dtype):
    """Row 1 on a smooth disparity field (narrow spans, all staged), on
    a field whose jumps exceed the staging buffer (the wide-span path, in
    the same kernel) and on a diverged one (tiles that stage a few pixels'
    rows or none), at the serving row width (240, C=256): within
    ``LOOKUP_TOL`` (1e-4) of plain in fp32, 1 bf16 ulp of max(1, |plain|)
    with bf16 feature maps and output; two calls bitwise equal."""
    rng = np.random.default_rng(31)
    b, h, w = 1, 6, 240
    st = build_corr_state(_randn(rng, b, h, w, 256).to(dev),
                          _randn(rng, b, h, w, 256).to(dev), 4,
                          corr_dtype=dtype)
    x = _lookup_field(dev, field, b, h, w, rng)
    before = cuda_alt.alt_corr.launches
    got = cuda_alt.alt_corr(st.fmap1, st.f2cat, st.widths, x, 4, dtype)
    got2 = cuda_alt.alt_corr(st.fmap1, st.f2cat, st.widths, x, 4, dtype)
    assert cuda_alt.alt_corr.launches == before + 2
    want = cuda_alt.alt_corr_plain(st.fmap1, st.f2cat, st.widths, x, 4,
                                   dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, got2)
    got, want = got.float(), want.float()
    if dtype == torch.bfloat16:
        err = (got - want).abs() / want.abs().clamp_min(1.0)
        assert float(err.max()) <= 2.0 ** -7
    else:
        assert float((got - want).abs().max()) <= 1e-4


# Row 2's card cases: (n_gru_layers, hd, corr_levels, batch, H, W, seed;
# the bf16 test takes 30 + seed).  hd 32 and 128, one to three GRU levels
# (ext 0 or hd), the 18-channel correlation of 2 levels, batch 2, a 37x53
# grid that no tile divides, and widths that are not whole 16-byte units
# (hd 18 in both forms, with ext 18; hd 20 in bf16), which the kernel
# copies into its workspace at the width rounded up.
GRU_CASES = [pytest.param(1, 128, 4, 2, 9, 13, 1, id="n1_hd128"),
             pytest.param(3, 128, 4, 2, 9, 13, 3, id="n3_hd128"),
             pytest.param(2, 32, 2, 2, 37, 53, 34,
                          id="n2_hd32_c18_b2_37x53"),
             pytest.param(3, 32, 4, 1, 37, 53, 35, id="n3_hd32_37x53"),
             pytest.param(1, 128, 2, 2, 37, 53, 129,
                          id="n1_hd128_c18_b2_37x53"),
             pytest.param(2, 18, 4, 2, 9, 13, 20, id="n2_hd18_ragged"),
             pytest.param(1, 20, 2, 1, 9, 13, 21, id="n1_hd20_c18_ragged")]


def _gru_case(dev, n, hd, levels, b, h, w, seed, dtype):
    cfg = RAFTStereoConfig(n_gru_layers=n, hidden_dims=(hd,) * n,
                           corr_levels=levels, corr_radius=4)
    model = RAFTStereo(cfg, device=dev, seed=1)
    e = hd if n > 1 else 0
    wpack = cuda_gru.pack_update_params(model.update_block, e, dtype)
    rng = np.random.default_rng(seed)
    args = [torch.tanh(_randn(rng, b, h, w, hd)).to(dtype),
            torch.tanh(_randn(rng, b, h, w, e)).to(dtype) if e else None,
            _randn(rng, b, h, w, cfg.cor_planes).to(dtype),
            torch.from_numpy(rng.uniform(-8, 2, (b, h, w, 1))
                             .astype(np.float32)),
            _randn(rng, b, h, w, hd).to(dtype),
            _randn(rng, b, h, w, hd).to(dtype),
            _randn(rng, b, h, w, hd).to(dtype)]
    return [a if a is None else a.to(dev) for a in args], wpack


@pytest.mark.parametrize("n,hd,levels,b,h,w,seed", GRU_CASES)
def test_gru_update_kernel_matches_plain(dev, n, hd, levels, b, h, w, seed):
    """Row 2's fp32 form (3xTF32 on the tensor cores); two calls bitwise
    equal."""
    args, wpack = _gru_case(dev, n, hd, levels, b, h, w, seed,
                            torch.float32)
    before = cuda_gru.gru_update.launches
    hk, dk = cuda_gru.gru_update(*args, wpack)
    hk2, dk2 = cuda_gru.gru_update(*args, wpack)
    assert cuda_gru.gru_update.launches == before + 2
    hp, dp = cuda_gru.gru_update_plain(*args, wpack)
    torch.cuda.synchronize()
    # no atomics, no split of K: every sum in one fixed order
    assert torch.equal(hk, hk2) and torch.equal(dk, dk2)
    # fp32 conv sums of up to ~3500 terms, reordered.
    torch.testing.assert_close(hk, hp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dk, dp, rtol=1e-4, atol=1e-4)


def _bwd_inputs(dev, rng, b, h, w, levels, radius, nan):
    st = build_corr_state(_randn(rng, b, h, w, 256).to(dev),
                          _randn(rng, b, h, w, 256).to(dev), levels)
    x = np.arange(w, dtype=np.float32) + rng.uniform(-w / 3, 10, (b, h, w))
    x[0, 0, :3] = [-200.5, w + 200.25, 1e6]
    if nan:
        x[-1, -1, -1] = np.nan
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    g = _randn(rng, b, h, w, levels * (2 * radius + 1)).to(dev)
    return st, x, g


@pytest.mark.parametrize("shape,levels,radius", [
    ((2, 11, 20), 4, 4), ((6, 80, 180), 4, 4), ((1, 2, 4), 4, 2)],
    ids=["hostile", "training", "zero_width_level"])
def test_alt_corr_backward_kernel_matches_plain(dev, shape, levels, radius):
    """Row 4 at a hostile shape (taps past both edges, a NaN coordinate),
    the training path's shape (6x80 rows of 180, C=256) and a width-0
    top level; bitwise repeatable."""
    rng = np.random.default_rng(5)
    st, x, g = _bwd_inputs(dev, rng, *shape, levels, radius,
                           nan=shape[2] > 4)
    before = cuda_alt.alt_corr_backward.launches
    k1 = cuda_alt.alt_corr_backward(st.fmap1, st.f2cat, st.widths, x, g,
                                    radius)
    k2 = cuda_alt.alt_corr_backward(st.fmap1, st.f2cat, st.widths, x, g,
                                    radius)
    assert cuda_alt.alt_corr_backward.launches == before + 2
    want = cuda_alt.alt_corr_backward_plain(st.fmap1, st.f2cat, st.widths, x,
                                            g, radius)
    torch.cuda.synchronize()
    for a, b, w in zip(k1, k2, want):
        # no floating-point atomics: two calls are bitwise equal
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
        assert torch.equal(a.isnan(), w.isnan())
        # sums of ~40-200 products of O(1) terms, in another order.
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-4,
                                   equal_nan=True)


@pytest.fixture(scope="module")
def first_form_bwd(tmp_path_factory):
    """The first form of row 4's kernel (``tests/cuda_ref/
    alt_corr_bwd_first.cu``), built with the port's nvcc flags."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    src = Path(__file__).parent / "cuda_ref" / "alt_corr_bwd_first.cu"
    out = tmp_path_factory.mktemp("first_form") / "libalt_corr_bwd_first.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).alt_corr_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_long]
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_void_p])

    def run(st, x, g, radius):
        b, h, w1, c = st.fmap1.shape
        df1, df2 = torch.empty_like(st.fmap1), torch.empty_like(st.f2cat)
        nlev = len(st.widths)
        ints = ctypes.c_int * nlev
        rc = fn(st.fmap1.data_ptr(), st.f2cat.data_ptr(), x.data_ptr(),
                g.data_ptr(), df1.data_ptr(), df2.data_ptr(), b * h, w1,
                st.f2cat.shape[2], c, radius, 1.0 / float(c) ** 0.5, nlev,
                ints(*[sum(st.widths[:i]) for i in range(nlev)]),
                ints(*st.widths),
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        return df1, df2

    return run


def _same_bits(a, b):
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)))


# Row 4 at the channel widths, radii and row widths it takes: C 128, 256,
# 512 (one, two and four 128-channel slices); radius 1 and 8; W1 180 (the
# recipe), 312 (evaluation-width crops) and 1320 (the widest row whose
# tables fit in shared memory at 4 levels of radius 4, as in the first
# form).
ROW4_CASES = [
    pytest.param((1, 8, 180), 256, 4, 4, id="recipe_w180_c256"),
    pytest.param((2, 3, 180), 128, 4, 1, id="w180_c128_r1"),
    pytest.param((1, 4, 180), 512, 4, 8, id="w180_c512_r8"),
    pytest.param((1, 6, 312), 256, 4, 4, id="w312_c256"),
    pytest.param((1, 2, 312), 512, 4, 8, id="w312_c512_r8"),
    pytest.param((1, 2, 1320), 128, 4, 4, id="widest_w1320_c128"),
    pytest.param((1, 2, 1320), 512, 4, 1, id="widest_w1320_c512_r1")]


@pytest.mark.parametrize("shape,c,levels,radius", ROW4_CASES)
def test_alt_corr_backward_every_form_matches_plain_and_first_form(
        dev, first_form_bwd, shape, c, levels, radius):
    """Row 4 at each of these shapes: within the plain version's tolerance
    where that is finite, NaN exactly where it is NaN and the same +-inf
    where it is infinite (a NaN coordinate poisons its pixel's df1 and its
    row's columns; an infinite cotangent gives the two columns its tap
    weights +-inf and the level's others in its row, and its pixel's df1,
    NaN), two calls bitwise equal, and the finite outputs bitwise equal to
    the first form of the kernel (the same summation order; the first
    form wrote NaN where the dense hat gives +-inf)."""
    b, h, w = shape
    rng = np.random.default_rng(w + c + radius)
    st = build_corr_state(_randn(rng, b, h, w, c).to(dev),
                          _randn(rng, b, h, w, c).to(dev), levels)
    x = np.arange(w, dtype=np.float32) + rng.uniform(-w / 3, 10, (b, h, w))
    x[0, 0, :3] = [-200.5, w + 200.25, 1e6]
    x[0, 0, 5] = 40.5     # level 1: tap 0 weights two columns inside it
    x[-1, -1, -1] = np.nan
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    g = _randn(rng, b, h, w, levels * (2 * radius + 1))
    g[0, 0, 5, 2 * radius + 1] = float("inf")   # level 1, tap 0
    g = g.to(dev)
    before = cuda_alt.alt_corr_backward.launches
    k1 = cuda_alt.alt_corr_backward(st.fmap1, st.f2cat, st.widths, x, g,
                                    radius)
    k2 = cuda_alt.alt_corr_backward(st.fmap1, st.f2cat, st.widths, x, g,
                                    radius)
    assert cuda_alt.alt_corr_backward.launches == before + 2
    first = first_form_bwd(st, x, g, radius)
    want = cuda_alt.alt_corr_backward_plain(st.fmap1, st.f2cat, st.widths, x,
                                            g, radius)
    torch.cuda.synchronize()
    for a, a2, f, w in zip(k1, k2, first, want):
        assert _same_bits(a, a2)
        ok, inf = torch.isfinite(w), w.isinf()
        assert torch.equal(a.isnan(), w.isnan()) and bool(a.isnan().any())
        assert torch.equal(a.isinf(), inf) and torch.equal(a[inf], w[inf])
        assert torch.equal(a[ok], f[ok])
        scale = max(1.0, float(w[ok].abs().max()))
        assert float((a[ok] - w[ok]).abs().max()) <= 1e-4 * scale
    assert int(k1[1][0, 0].isinf().any(-1).sum()) == 2


def test_wrappers_raise_instead_of_falling_back(dev):
    rng = np.random.default_rng(2)
    st = build_corr_state(_randn(rng, 1, 2, 8, 256).to(dev),
                          _randn(rng, 1, 2, 8, 256).to(dev), 2)
    x = torch.zeros((1, 2, 8), device=dev)
    with pytest.raises(ValueError):  # x on the CPU, features on the card
        cuda_alt.alt_corr(st.fmap1, st.f2cat, st.widths, x.cpu(), 2)
    with pytest.raises(ValueError):  # C=192 is not a kernel width
        cuda_alt.alt_corr(st.fmap1[..., :192].contiguous(),
                          st.f2cat[..., :192].contiguous(), st.widths, x, 2)
    g = torch.zeros((1, 2, 8, 10), device=dev)
    with pytest.raises(ValueError):  # the cotangent on the CPU
        cuda_alt.alt_corr_backward(st.fmap1, st.f2cat, st.widths, x,
                                   g.cpu(), 2)
    with pytest.raises(ValueError):  # a cotangent of the wrong width
        cuda_alt.alt_corr_backward(st.fmap1, st.f2cat, st.widths, x,
                                   g[..., :9].contiguous(), 2)
    with pytest.raises(ValueError):  # a non-contiguous cotangent
        cuda_alt.alt_corr_backward(st.fmap1, st.f2cat, st.widths, x,
                                   g.transpose(1, 2), 2)


def test_train_step_on_card_matches_cpu(dev):
    """One train-mode forward and backward on the card (kernels) against
    the CPU (plain versions): loss within 1e-4 relative, every gradient
    within 1e-3 of the largest CPU gradient entry."""
    from raftstereo_tpu_torch.train.loss import sequence_loss

    cfg = RAFTStereoConfig(n_gru_layers=3, hidden_dims=(32, 32, 32),
                           corr_levels=2, corr_radius=2)
    rng = np.random.default_rng(6)
    batch = [torch.from_numpy(rng.uniform(0, 255, (1, 32, 48, 3))
                              .astype(np.float32)) for _ in range(2)]
    batch += [torch.from_numpy(-rng.uniform(1, 20, (1, 32, 48, 1))
                               .astype(np.float32)), torch.ones(1, 32, 48)]
    out = []
    for device in (dev, torch.device("cpu")):
        m = RAFTStereo(cfg, device=device, seed=4)
        preds = m(*(t.to(device) for t in batch[:2]), iters=3,
                  test_mode=False)
        loss, _ = sequence_loss(preds, *(t.to(device) for t in batch[2:]))
        loss.backward()
        out.append((float(loss.detach()),
                    {k: p.grad.cpu() for k, p in m.named_parameters()}))
    (lg, gg), (lc, gc) = out
    assert lg == pytest.approx(lc, rel=1e-4)
    gmax = max(float(t.abs().max()) for t in gc.values())
    for k in gc:
        assert float((gg[k] - gc[k]).abs().max()) <= 1e-3 * gmax, k


def test_forward_on_card_matches_cpu(dev):
    cfg = RAFTStereoConfig(n_gru_layers=3, hidden_dims=(32, 32, 32),
                           corr_levels=2, corr_radius=2)
    gpu = RAFTStereo(cfg, device=dev, seed=4)
    cpu = RAFTStereo(cfg, device="cpu", seed=4)
    rng = np.random.default_rng(3)
    imgs = [torch.from_numpy(rng.uniform(0, 255, (1, 32, 48, 3))
                             .astype(np.float32)) for _ in range(2)]
    lo_g, up_g = gpu(*(i.to(dev) for i in imgs), iters=3)
    lo_c, up_c = cpu(*imgs, iters=3)
    # The thresholds of the JAX parity tests: fp32 rounding differences
    # carried through three GRU iterations.
    torch.testing.assert_close(lo_g.cpu(), lo_c, rtol=0, atol=2e-3)
    torch.testing.assert_close(up_g.cpu(), up_c, rtol=0, atol=5e-3)


# ------------------------------------------------- fused encoder kernels

def _aff(rng, dev, b, c, const=False):
    """A per-(image, channel) prep affine; its shift is positive in every
    channel, so zero padding before the prep would show at the border."""
    s = rng.uniform(0.5, 1.5, (b, c)).astype(np.float32)
    if const:
        s[:, 0] = 1.0 / np.sqrt(1e-5)  # a constant channel's rstd
    t = rng.uniform(0.05, 0.5, (b, c)).astype(np.float32)
    return torch.from_numpy(s).to(dev), torch.from_numpy(t).to(dev)


def _wb(rng, dev, co, ci, k):
    w = _randn(rng, co, ci, k, k) * (2.0 / (ci * k * k)) ** 0.5
    return w.to(dev), (_randn(rng, co) * 0.1).to(dev)


def _twice(fn, *args, **kw):
    """Two kernel calls on the same inputs (their results) and the plain
    version's, after checking the wrapper counted both launches."""
    before = fn.launches
    k1, k2 = fn(*args, **kw), fn(*args, **kw)
    assert fn.launches == before + 2
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else
           tuple(t.cpu() for t in a) if isinstance(a, tuple) else a
           for a in args]
    want = fn(*cpu, **{k: v.cpu() if isinstance(v, torch.Tensor) else
                       tuple(t.cpu() for t in v) if isinstance(v, tuple)
                       else v for k, v in kw.items()})
    torch.cuda.synchronize()
    return k1, k2, want


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out if o is not None for t in _leaves(o)]


def _assert_kernel(k1, k2, want, rtol=1e-4):
    """Bitwise repeatable; within rtol of max(1, |plain|) of the plain
    version (fp32 convolution sums of up to 864 terms and image sums,
    reordered; FMAs where the plain version rounds twice)."""
    for a, b, w in zip(_leaves(k1), _leaves(k2), _leaves(want)):
        assert torch.equal(a, b)
        scale = max(1.0, float(w.abs().max()))
        assert float((a.cpu() - w).abs().max()) <= rtol * scale


# Hostile shapes: odd H, H not a multiple of the 8-row tile, W = 2 and W
# not a multiple of the 32-column tile, stride-2 edges (odd input sizes).
@pytest.mark.parametrize("b,h,w", [(2, 13, 2), (1, 9, 37), (3, 21, 70)])
def test_stem_conv7_kernels_match_plain(dev, b, h, w):
    rng = np.random.default_rng(h)
    img = _randn(rng, b, 3, h, w).to(dev)
    wt, bias = _wb(rng, dev, 64, 3, 7)
    for fn in (cuda_encoder.stem_conv7, cuda_encoder.stem_conv7_s2):
        _assert_kernel(*_twice(fn, img, wt, bias))
        y, st = fn(img, wt, bias, want_stats=False)
        assert st is None


@pytest.mark.parametrize("b,want_stats", [(1, False), (2, True), (1, True),
                                          (2, False)],
                         ids=["cnet_b1", "fnet_b2_sums", "b1_sums",
                              "b2_no_sums"])
def test_stem_conv7_tensor_core_serving_shapes(dev, b, want_stats):
    """Row 13 on the tensor cores at the fused serving input (576x960, the
    model's 3 -> 64 channels): cnet's batch 1 without sums and fnet's
    batch 2 with sums (and the other two pairings); within ENC_TOL (1e-4
    of max(1, |plain|)) of plain, the sums per pixel; two calls bitwise
    equal.  The plain version runs on the card in full fp32 (cuDNN's
    default TF32 would be ~3e-4 off)."""
    fp32_numerics()
    rng = np.random.default_rng(13)
    img = torch.tanh(_randn(rng, b, 3, 576, 960)).to(dev)
    wt, bias = _wb(rng, dev, 64, 3, 7)
    before = cuda_encoder.stem_conv7.launches
    k1 = cuda_encoder.stem_conv7(img, wt, bias, want_stats=want_stats)
    k2 = cuda_encoder.stem_conv7(img, wt, bias, want_stats=want_stats)
    assert cuda_encoder.stem_conv7.launches == before + 2
    want = cuda_encoder.conv_plain(img, wt, bias, 1, want_stats=want_stats)
    torch.cuda.synchronize()
    assert (k1[1] is None) == (not want_stats)
    for a, c, p in zip(_leaves(k1), _leaves(k2), _leaves(want)):
        assert torch.equal(a, c)
        n = 576.0 * 960 if a.dim() == 2 else 1.0
        scale = max(1.0, float((p / n).abs().max()))
        assert float(((a - p) / n).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("b,want_stats", [(1, False), (2, True)],
                         ids=["cnet_b1", "fnet_b2_sums"])
def test_stem_conv7_s2_tensor_core_serving_shapes(dev, b, want_stats):
    """Row 12 on the tensor cores at the ``n_downsample=3`` fused serving
    input (576x960 -> 288x480, 3 -> 64 channels): cnet's batch 1 without
    sums and fnet's batch 2 with sums; within ENC_TOL (1e-4 of max(1,
    |plain|)) of plain in full fp32, the sums per output pixel; two calls
    bitwise equal, each counted once."""
    fp32_numerics()
    rng = np.random.default_rng(12)
    img = torch.tanh(_randn(rng, b, 3, 576, 960)).to(dev)
    wt, bias = _wb(rng, dev, 64, 3, 7)
    fn = cuda_encoder.stem_conv7_s2
    before = fn.launches
    k1 = fn(img, wt, bias, want_stats=want_stats)
    k2 = fn(img, wt, bias, want_stats=want_stats)
    assert fn.launches == before + 2
    want = cuda_encoder.conv_plain(img, wt, bias, 2, want_stats=want_stats)
    torch.cuda.synchronize()
    assert k1[0].shape == (b, 64, 288, 480)
    assert (k1[1] is None) == (not want_stats)
    for a, c, p in zip(_leaves(k1), _leaves(k2), _leaves(want)):
        assert torch.equal(a, c)
        n = 288.0 * 480 if a.dim() == 2 else 1.0
        scale = max(1.0, float((p / n).abs().max()))
        assert float(((a - p) / n).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("cin,b,h,w", [(64, 2, 13, 2), (64, 1, 19, 45),
                                       (96, 3, 9, 33)])
def test_stage_and_l2_conv_kernels_match_plain(dev, cin, b, h, w):
    """Rows 9 and 16, plain and residual forms, with and without sums;
    channel 0 is constant (variance 0), its prep scale 1/sqrt(1e-5)."""
    rng = np.random.default_rng(cin + h)
    x = _randn(rng, b, cin, h, w)
    x[:, 0] = 0.25
    x = x.to(dev)
    r = _randn(rng, b, cin, h, w).to(dev)
    aff, raff = _aff(rng, dev, b, cin, const=True), _aff(rng, dev, b, cin)
    wt, bias = _wb(rng, dev, cin, cin, 3)
    for fn in (cuda_encoder.stage_conv, cuda_encoder.l2_conv):
        _assert_kernel(*_twice(fn, x, aff, wt, bias))
        _assert_kernel(*_twice(fn, x, aff, wt, bias, res=r, res_aff=raff))
        _assert_kernel(*_twice(fn, x, aff, wt, bias, want_stats=False))


@pytest.mark.parametrize("b,h,w", [(2, 14, 4), (1, 17, 66), (3, 30, 2)])
def test_l2_entry_kernel_matches_plain(dev, b, h, w):
    rng = np.random.default_rng(w)
    t = torch.relu(_randn(rng, b, 64, h, w)).to(dev)
    wt, bias = _wb(rng, dev, 96, 64, 3)
    wp, bp = _wb(rng, dev, 96, 64, 1)
    _assert_kernel(*_twice(cuda_encoder.l2_entry, t, wt, bias, wp, bp))


# Rows 9 and 15 on the tensor cores (csrc/enc_conv_tc.cu): the hostile
# widths above (W not a multiple of the 32- or 16-column tile nor of 4, so
# no row is whole 16-byte units; odd sizes at stride 2; H not a multiple
# of the 8-row tile) and a training-sized 12x64x40x90.
TC_CASES = [(2, 13, 2), (1, 9, 37), (3, 21, 70), (1, 19, 45), (3, 9, 33),
            (2, 14, 4), (1, 17, 66), (12, 40, 90)]


@pytest.mark.parametrize("b,h,w", TC_CASES)
def test_tensor_core_conv_kernels_match_plain(dev, monkeypatch, b, h, w):
    """Row 9 (prep and residual forms) and row 15 (entry conv and
    projection) against their plain versions, with and without sums: two
    calls bitwise equal, one launch each, and the plain versions patched
    to raise while the kernels run."""
    rng = np.random.default_rng(100 + w)
    x = _randn(rng, b, 64, h, w)
    x[:, 0] = 0.25
    x = x.to(dev)
    r = _randn(rng, b, 64, h, w).to(dev)
    aff, raff = _aff(rng, dev, b, 64, const=True), _aff(rng, dev, b, 64)
    wt, bias = _wb(rng, dev, 64, 64, 3)
    we, be = _wb(rng, dev, 96, 64, 3)
    wp, bp = _wb(rng, dev, 96, 64, 1)
    t = torch.relu(x)

    def cpu(v):
        return tuple(cpu(u) for u in v) if isinstance(v, tuple) else v.cpu()

    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card path")

    for fn, args, kw in ((cuda_encoder.stage_conv, (x, aff, wt, bias), {}),
                         (cuda_encoder.stage_conv, (x, aff, wt, bias),
                          dict(res=r, res_aff=raff)),
                         (cuda_encoder.l2_entry, (t, we, be, wp, bp), {})):
        for ws in (True, False):
            want = fn(*map(cpu, args), **{k: cpu(v) for k, v in kw.items()},
                      want_stats=ws)
            with monkeypatch.context() as m:
                for name in ("conv_plain", "entry_plain", "stats_plain",
                             "prep"):
                    m.setattr(cuda_encoder, name, boom)
                before = fn.launches
                k1 = fn(*args, **kw, want_stats=ws)
                k2 = fn(*args, **kw, want_stats=ws)
                torch.cuda.synchronize()
                assert fn.launches == before + 2
            assert len(_leaves(k1)) == len(_leaves(want)) == (
                (3 if fn is cuda_encoder.stage_conv else 6) if ws else
                (1 if fn is cuda_encoder.stage_conv else 2))
            _assert_kernel(k1, k2, want)


@pytest.mark.parametrize("b,h,w", TC_CASES)
def test_l2_conv_tensor_core_kernel_matches_plain(dev, monkeypatch, b, h, w):
    """Row 16 (layer2's 3x3 96->96 conv, 8x16 x 96 tiles) in its prep and
    res_proj forms (no relu on the projection term), with and without
    sums, at the hostile widths: two calls bitwise equal, one launch each,
    the plain versions patched to raise while the kernel runs."""
    rng = np.random.default_rng(200 + w)
    x = _randn(rng, b, 96, h, w)
    x[:, 0] = 0.25
    x = x.to(dev)
    p = _randn(rng, b, 96, h, w).to(dev)
    aff, paff = _aff(rng, dev, b, 96, const=True), _aff(rng, dev, b, 96)
    wt, bias = _wb(rng, dev, 96, 96, 3)

    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card path")

    fn = cuda_encoder.l2_conv
    for kw in ({}, dict(res=p, res_aff=paff)):
        for ws in (True, False):
            want = fn(x.cpu(), tuple(a.cpu() for a in aff), wt.cpu(),
                      bias.cpu(), want_stats=ws,
                      **{k: (v.cpu() if isinstance(v, torch.Tensor)
                             else tuple(a.cpu() for a in v))
                         for k, v in kw.items()})
            with monkeypatch.context() as m:
                for name in ("conv_plain", "stats_plain", "prep"):
                    m.setattr(cuda_encoder, name, boom)
                before = fn.launches
                k1 = fn(x, aff, wt, bias, want_stats=ws, **kw)
                k2 = fn(x, aff, wt, bias, want_stats=ws, **kw)
                torch.cuda.synchronize()
                assert fn.launches == before + 2
            assert len(_leaves(k1)) == len(_leaves(want)) == (3 if ws else 1)
            _assert_kernel(k1, k2, want)


@pytest.mark.parametrize("shape", [(2, 64, 13, 2), (1, 96, 7, 9),
                                   (6, 64, 24, 40)])
def test_stats_and_finish_kernels_match_plain(dev, shape):
    rng = np.random.default_rng(shape[2])
    b, c = shape[:2]
    x = (_randn(rng, *shape) * 3 + 10).to(dev)
    x[:, 1] = 7.0  # a constant channel
    _assert_kernel(*_twice(cuda_encoder.plane_stats, x))
    ts = [_randn(rng, *shape).to(dev) for _ in range(3)]
    affs = [_aff(rng, dev, b, c) for _ in range(3)]
    args = [v for pair in zip(ts, affs) for v in pair]
    for fn in (cuda_encoder.stage_finish, cuda_encoder.l2_finish):
        _assert_kernel(*_twice(fn, *args), rtol=1e-5)


def test_encoder_wrappers_raise_instead_of_falling_back(dev):
    rng = np.random.default_rng(9)
    x = _randn(rng, 1, 64, 8, 8).to(dev)
    aff = _aff(rng, dev, 1, 64)
    wt, bias = _wb(rng, dev, 64, 64, 3)
    with pytest.raises(ValueError):  # the weights on the CPU
        cuda_encoder.stage_conv(x, aff, wt.cpu(), bias.cpu())
    with pytest.raises(ValueError):  # Cout 48 is not a multiple of 32
        cuda_encoder.stage_conv(x, aff, wt[:48], bias[:48])
    with pytest.raises(ValueError):  # a non-contiguous input
        cuda_encoder.stage_conv(x.transpose(2, 3), aff, wt, bias)
    with pytest.raises(ValueError):  # an affine of the wrong width
        cuda_encoder.stage_conv(x, (aff[0][:, :32], aff[1][:, :32]), wt,
                                bias)
    with pytest.raises(ValueError):  # float64
        cuda_encoder.plane_stats(x.double())
    with pytest.raises(ValueError):  # one operand on the CPU
        cuda_encoder.dual_sums(x, x.cpu())
    with pytest.raises(ValueError):  # shapes differ
        cuda_encoder.dual_sums(x, x[:, :32].contiguous())
    with pytest.raises(ValueError):  # a non-contiguous operand
        cuda_encoder.dual_sums(x, x.transpose(2, 3))


# Hostile shapes: H*W odd and not a multiple of 4 (the scalar path), one
# plane smaller than the block, the recipe's 230,400-pixel planes.
@pytest.mark.parametrize("shape", [(2, 64, 13, 7), (1, 8, 3, 5),
                                   (2, 64, 320, 720)])
def test_dual_sums_kernel_matches_plain(dev, shape):
    """Row 14: (sum of u, sum of u*v) per plane, bitwise repeatable,
    within 1e-5 of max(1, |plain|) per pixel (fp32 sums of up to 230,400
    terms in another order)."""
    rng = np.random.default_rng(shape[2])
    u = _randn(rng, *shape).to(dev)
    v = (_randn(rng, *shape) * 2 + 0.5).to(dev)
    k1, k2, want = _twice(cuda_encoder.dual_sums, u, v)
    n = shape[2] * shape[3]
    for a, b, w in zip(k1, k2, want):
        assert torch.equal(a, b)
        scale = max(1.0, float((w / n).abs().max()))
        assert float(((a.cpu() - w) / n).abs().max()) <= 1e-5 * scale


def test_fused_train_step_on_card_matches_cpu(dev, monkeypatch):
    """A ``fused_encoder=True`` train step on the card (kernels, every
    plain version patched to raise) against the CPU (plain versions):
    loss within 1e-4 relative, every gradient within 1e-3 of the largest
    CPU entry.  At batch 1 fnet's 2 images take the conv1 stage, whose
    backward takes 5 dual sums; cnet's frozen-BN stage takes none."""
    from raftstereo_tpu_torch.train.loss import sequence_loss

    cfg = RAFTStereoConfig(n_gru_layers=3, hidden_dims=(32, 32, 32),
                           corr_levels=2, corr_radius=2, fused_encoder=True)
    rng = np.random.default_rng(6)
    batch = [torch.from_numpy(rng.uniform(0, 255, (1, 32, 48, 3))
                              .astype(np.float32)) for _ in range(2)]
    batch += [torch.from_numpy(-rng.uniform(1, 20, (1, 32, 48, 1))
                               .astype(np.float32)), torch.ones(1, 32, 48)]
    out = []
    for device in (torch.device("cpu"), dev):
        if device.type == "cuda":
            def boom(*a, **k):
                raise AssertionError("a plain version ran on the card path")

            for name in ("conv_plain", "entry_plain", "finish_plain",
                         "stats_plain", "dual_sums_plain", "prep"):
                monkeypatch.setattr(cuda_encoder, name, boom)
            for fn in cuda_encoder.WRAPPERS:
                fn.launches = 0
        m = RAFTStereo(cfg, device=device, seed=4)
        preds = m(*(t.to(device) for t in batch[:2]), iters=3,
                  test_mode=False)
        loss, _ = sequence_loss(preds, *(t.to(device) for t in batch[2:]))
        loss.backward()
        out.append((float(loss.detach()),
                    {k: p.grad.cpu() for k, p in m.named_parameters()}))
    assert cuda_encoder.dual_sums.launches == 5
    assert cuda_encoder.stem_conv7.launches == 2
    (lc, gc), (lg, gg) = out
    assert lg == pytest.approx(lc, rel=1e-4)
    gmax = max(float(t.abs().max()) for t in gc.values())
    for k in gc:
        assert float((gg[k] - gc[k]).abs().max()) <= 1e-3 * gmax, k


@pytest.mark.parametrize("batch,ds", [(1, 2), (3, 2), (1, 3)],
                         ids=["1", "3", "ds3"])
def test_fused_encoder_on_card_never_runs_plain(dev, batch, ds, monkeypatch):
    """``fused_encoder=True`` on CUDA tensors: every plain version patched
    to raise, the model runs, launches counted per row (batch 3: fnet's 6
    images take plain conv1 + the stats kernel; ``n_downsample=3``: both
    encoders' conv1 is the stride-2 stem), and the result matches the CPU
    forward (plain versions) within the parity thresholds."""
    cfg = RAFTStereoConfig(n_gru_layers=3, hidden_dims=(32, 32, 32),
                           corr_levels=2, corr_radius=2, fused_encoder=True,
                           n_downsample=ds)
    gpu = RAFTStereo(cfg, device=dev, seed=4)
    cpu = RAFTStereo(cfg, device="cpu", seed=4)
    rng = np.random.default_rng(batch)
    hw = (32, 48) if ds == 2 else (32, 64)
    imgs = [torch.from_numpy(rng.uniform(0, 255, (batch,) + hw + (3,))
                             .astype(np.float32)) for _ in range(2)]
    lo_c, up_c = cpu(*imgs, iters=3)

    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card path")

    for name in ("conv_plain", "entry_plain", "finish_plain", "stats_plain",
                 "prep"):
        monkeypatch.setattr(cuda_encoder, name, boom)
    for fn in cuda_encoder.WRAPPERS:
        fn.launches = 0
    lo_g, up_g = gpu(*(i.to(dev) for i in imgs), iters=3)
    torch.cuda.synchronize()
    got = {fn.__name__: fn.launches for fn in cuda_encoder.WRAPPERS}
    big = batch > 2  # fnet sees 2 * batch images
    stems = 2 - big
    assert got == {"stem_conv7": stems * (ds == 2),
                   "stem_conv7_s2": stems * (ds == 3),
                   "stage_conv": 8, "plane_stats": int(big),
                   "stage_finish": 2, "l2_entry": 2, "l2_conv": 6,
                   "l2_finish": 2, "dual_sums": 0}
    torch.testing.assert_close(lo_g.cpu(), lo_c, rtol=0, atol=2e-3)
    torch.testing.assert_close(up_g.cpu(), up_c, rtol=0, atol=5e-3)


# ------------------------------------- fused encoder kernels in bf16

BF = torch.bfloat16
# The bf16 forms against their bf16 plain versions: a convolution's exact
# products summed in fp32 in another order round to the other bf16
# neighbour at a boundary (1 ulp of max(1, |plain|), at least 99% of the
# outputs equal); its fp32 output sums within 1e-4 of max(1, |plain|)
# per pixel, as the fp32 forms; the finishes round each op as plain does
# (bitwise); row 10's fp32 sums of bf16 values within 1e-5 per pixel.
ENC_BF16_ULPS, ENC_BF16_EQUAL = 1.0, 0.99


def _assert_bf16(k1, k2, want, n=1.0, equal=ENC_BF16_EQUAL):
    """Bitwise repeatable; bf16 outputs within ENC_BF16_ULPS of the plain
    version with ``equal`` of them equal, fp32 (B, C) sums within 1e-4
    per pixel (divided by ``n``)."""
    for a, b, w in zip(_leaves(k1), _leaves(k2), _leaves(want)):
        assert torch.equal(a, b)
        a, w = a.cpu(), w.cpu()
        assert a.dtype == w.dtype
        if a.dtype == BF:
            a, w = a.float(), w.float()
            ulps = float(((a - w).abs() / w.abs().clamp_min(1.0)).max())
            assert ulps <= ENC_BF16_ULPS * 2.0 ** -7
            assert float((a == w).float().mean()) >= equal
        else:
            scale = max(1.0, float((w / n).abs().max()))
            assert float(((a - w) / n).abs().max()) <= 1e-4 * scale


def _bf16_case(rng, dev, b, cin, h, w):
    x = (_randn(rng, b, cin, h, w) * 2 + 0.3).to(BF)
    x[:, 0] = 0.25
    r = (_randn(rng, b, cin, h, w) * 2 - 0.3).to(BF)
    return x.to(dev), r.to(dev)


def _cpu(v):
    if isinstance(v, tuple):
        return tuple(_cpu(u) for u in v)
    return v.cpu() if isinstance(v, torch.Tensor) else v


def _twice_bf16(fn, args, kw, monkeypatch):
    """Two kernel calls with every plain version patched to raise, one
    launch each, and the plain version on the CPU."""
    want = fn(*map(_cpu, args), **{k: _cpu(v) for k, v in kw.items()})

    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card path")

    with monkeypatch.context() as m:
        for name in ("conv_plain", "entry_plain", "finish_plain",
                     "stats_plain", "dual_sums_plain", "prep"):
            m.setattr(cuda_encoder, name, boom)
        before = fn.launches
        k1, k2 = fn(*args, **kw), fn(*args, **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + 2
    return k1, k2, want


# The fp32 forms' hostile shapes (odd sizes, W not a multiple of the
# tiles nor of 8, H not a multiple of the 8-row tile), a 16-channel
# conv (one stage, Cin not a multiple of 16 for 12) and the serving
# path's layer2 width.
BF16_CASES = [(2, 13, 2), (1, 9, 37), (3, 21, 70), (2, 14, 4), (1, 17, 66),
              (2, 40, 90)]


@pytest.mark.parametrize("b,h,w", BF16_CASES)
def test_encoder_convs_bf16_match_plain(dev, monkeypatch, b, h, w):
    """Rows 9 (prep, residual), 15 (conv and projection) and 16 (prep,
    residual-projection) in bf16, with and without sums, and rows 13 and
    12 (the stems) on a bf16 image."""
    rng = np.random.default_rng(300 + w)
    x, r = _bf16_case(rng, dev, b, 64, h, w)
    y, p = _bf16_case(rng, dev, b, 96, h, w)
    aff, raff = _aff(rng, dev, b, 64, const=True), _aff(rng, dev, b, 64)
    a96, p96 = _aff(rng, dev, b, 96), _aff(rng, dev, b, 96)
    wt, bias = _wb(rng, dev, 64, 64, 3)
    we, be = _wb(rng, dev, 96, 64, 3)
    wp, bp = _wb(rng, dev, 96, 64, 1)
    wl, bl = _wb(rng, dev, 96, 96, 3)
    w7, b7 = _wb(rng, dev, 64, 3, 7)
    img = torch.tanh(_randn(rng, b, 3, h, w)).to(BF).to(dev)
    t = torch.relu(x)
    n, n2 = float(h * w), float(((h + 1) // 2) * ((w + 1) // 2))
    ce = cuda_encoder
    for fn, args, kw, nn in (
            (ce.stage_conv, (x, aff, wt, bias), {}, n),
            (ce.stage_conv, (x, aff, wt, bias), dict(res=r, res_aff=raff), n),
            (ce.l2_entry, (t, we, be, wp, bp), {}, n2),
            (ce.l2_conv, (y, a96, wl, bl), {}, n),
            (ce.l2_conv, (y, a96, wl, bl), dict(res=p, res_aff=p96), n),
            (ce.stem_conv7, (img, w7, b7), {}, n),
            (ce.stem_conv7_s2, (img, w7, b7), {}, n2)):
        for ws in (True, False):
            k1, k2, want = _twice_bf16(fn, args, dict(kw, want_stats=ws),
                                       monkeypatch)
            assert k1[0].dtype == BF
            _assert_bf16(k1, k2, want, nn)


# Rows 9, 15 and 16's bf16 forms on enc_conv_wg.cu: ragged shapes (2-byte
# loads and stores: W not a multiple of 8; H and W not multiples of the
# tile) and shapes whose rows are whole 16-byte vectors (W a multiple of 8
# but not of the 64-column tile, so the last tile overhangs).
WG_CASES = [(1, 37, 53), (3, 41, 70), (2, 19, 136), (1, 9, 8), (2, 30, 72)]


@pytest.mark.parametrize("b,h,w", WG_CASES)
def test_l2_wgmma_bf16_kernel_matches_plain(dev, monkeypatch, b, h, w):
    """Row 16 (prep and res_proj forms, 96 -> 96) and row 15 (conv and
    projection, 64 -> 96, stride 2) in bf16 on the wgmma kernel, with and
    without sums: one launch each, two calls bitwise equal, within 1 bf16
    ulp of the plain version with at least 99% equal, sums within 1e-4
    per pixel; the plain versions patched to raise."""
    rng = np.random.default_rng(500 + w)
    y, p = _bf16_case(rng, dev, b, 96, h, w)
    t = torch.relu(_bf16_case(rng, dev, b, 64, h, w)[1])
    a96, p96 = _aff(rng, dev, b, 96, const=True), _aff(rng, dev, b, 96)
    wl, bl = _wb(rng, dev, 96, 96, 3)
    we, be = _wb(rng, dev, 96, 64, 3)
    wp, bp = _wb(rng, dev, 96, 64, 1)
    n, n2 = float(h * w), float(((h + 1) // 2) * ((w + 1) // 2))
    ce = cuda_encoder
    for fn, args, kw, nn in (
            (ce.l2_conv, (y, a96, wl, bl), {}, n),
            (ce.l2_conv, (y, a96, wl, bl), dict(res=p, res_aff=p96), n),
            (ce.l2_entry, (t, we, be, wp, bp), {}, n2)):
        for ws in (True, False):
            k1, k2, want = _twice_bf16(fn, args, dict(kw, want_stats=ws),
                                       monkeypatch)
            assert k1[0].dtype == BF
            assert len(_leaves(k1)) == len(_leaves(want))
            _assert_bf16(k1, k2, want, nn)


@pytest.mark.parametrize("b,h,w", WG_CASES)
def test_stage_wgmma_bf16_kernel_matches_plain(dev, monkeypatch, b, h, w):
    """Row 9 (64 -> 64, stride 1) in bf16 on the wgmma kernel's N = 64
    instance, in its prep form and its residual form (a relu on both
    terms), with and without sums: one launch each, two calls bitwise
    equal, within 1 bf16 ulp of the plain version with at least 99%
    equal, sums within 1e-4 per pixel; the plain versions patched to
    raise."""
    rng = np.random.default_rng(700 + w)
    x, r = _bf16_case(rng, dev, b, 64, h, w)
    aff, raff = _aff(rng, dev, b, 64, const=True), _aff(rng, dev, b, 64)
    wt, bias = _wb(rng, dev, 64, 64, 3)
    for kw in ({}, dict(res=r, res_aff=raff)):
        for ws in (True, False):
            k1, k2, want = _twice_bf16(cuda_encoder.stage_conv,
                                       (x, aff, wt, bias),
                                       dict(kw, want_stats=ws), monkeypatch)
            assert k1[0].dtype == BF
            assert len(_leaves(k1)) == len(_leaves(want))
            _assert_bf16(k1, k2, want, float(h * w))


def test_stage_wgmma_bf16_kernel_refuses(dev):
    """Row 9's wgmma instance takes 3x3 stride-1 convs to 64 outputs from
    at most 64 channels: more channels in or out raise, no fallback."""
    rng = np.random.default_rng(8)
    x = _bf16_case(rng, dev, 1, 80, 8, 16)[0]
    w80, b80 = _wb(rng, dev, 64, 80, 3)
    with pytest.raises(ValueError):
        cuda_encoder.stage_conv(x, _aff(rng, dev, 1, 80), w80, b80)
    x = _bf16_case(rng, dev, 1, 64, 8, 16)[0]
    w96, b96 = _wb(rng, dev, 96, 64, 3)
    with pytest.raises(ValueError):
        cuda_encoder.stage_conv(x, _aff(rng, dev, 1, 64), w96, b96)


def test_l2_wgmma_bf16_kernel_refuses(dev):
    """The wgmma kernel takes 3x3 convs to 96 outputs from at most 96
    (row 16) or 64 (row 15) channels: anything else raises, no
    fallback."""
    rng = np.random.default_rng(7)
    y = _bf16_case(rng, dev, 1, 112, 8, 16)[0]
    a = _aff(rng, dev, 1, 112)
    wl, bl = _wb(rng, dev, 96, 112, 3)
    with pytest.raises(ValueError):
        cuda_encoder.l2_conv(y, a, wl, bl)
    y = _bf16_case(rng, dev, 1, 96, 8, 16)[0]
    w64, b64 = _wb(rng, dev, 64, 96, 3)
    with pytest.raises(ValueError):
        cuda_encoder.l2_conv(y, _aff(rng, dev, 1, 96), w64, b64)


@pytest.mark.parametrize("shift", [0, 1, 3, 7, 8, 13, 66])
def test_wgmma_shifted_window_descriptor(dev, shift):
    """``enc_conv_wg.cu``'s A descriptors start a tap's window at any
    pixel: one m64n96k16 ``wgmma`` whose A starts ``shift`` 16-byte rows
    into two planes of 8 channels (LBO the plane, SBO 128 bytes) and
    whose B is a (k-step, tap) block of ``wg_pack`` gives the product of
    pixels shift .. shift + 63 with that tap's weights (exact bf16
    products, fp32 sums of 16)."""
    rng = np.random.default_rng(20 + shift)
    npix = 136
    a = torch.from_numpy(rng.normal(size=(npix, 16)).astype(np.float32)
                         ).to(BF)
    img = torch.cat([a[:, :8].reshape(-1), a[:, 8:].reshape(-1)]).to(dev)
    wt = _randn(rng, 96, 16, 3, 3)
    tap = shift % 9
    blk = cuda_encoder.wg_pack(wt)[0, tap].contiguous().to(dev)
    out = torch.empty((64, 96), dtype=torch.float32, device=dev)
    fn = _build.load("enc_conv_wg").enc_conv_wg_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    rc = fn(img.data_ptr(), blk.data_ptr(), out.data_ptr(), npix * 16,
            shift, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    want = (a[shift:shift + 64].double()
            @ wt[:, :, tap // 3, tap % 3].to(BF).double().T)
    torch.testing.assert_close(out.cpu().double(), want, rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 64, 13, 7), (1, 96, 7, 9),
                                   (6, 64, 24, 40)])
def test_stats_and_finish_bf16_match_plain(dev, monkeypatch, shape):
    """Row 10 on bf16 planes (the scalar path where H*W is not a multiple
    of 8), within 1e-5 per pixel; rows 11 and 17 bitwise equal to their
    plain versions."""
    rng = np.random.default_rng(shape[3])
    b, c = shape[:2]
    x = (_randn(rng, *shape) * 3 + 10).to(BF).to(dev)
    k1, k2, want = _twice_bf16(cuda_encoder.plane_stats, (x,), {},
                               monkeypatch)
    n = shape[2] * shape[3]
    for a, a2, w in zip(k1, k2, want):
        assert torch.equal(a, a2) and a.dtype == torch.float32
        scale = max(1.0, float((w / n).abs().max()))
        assert float(((a.cpu() - w) / n).abs().max()) <= 1e-5 * scale
    ts = [(_randn(rng, *shape) * 2).to(BF).to(dev) for _ in range(3)]
    affs = [_aff(rng, dev, b, c) for _ in range(3)]
    args = tuple(v for pair in zip(ts, affs) for v in pair)
    for fn in (cuda_encoder.stage_finish, cuda_encoder.l2_finish):
        k1, k2, want = _twice_bf16(fn, args, {}, monkeypatch)
        assert k1.dtype == BF
        assert torch.equal(k1, k2) and torch.equal(k1.cpu(), want)


def test_encoder_wrappers_bf16_refuse_mixes(dev):
    """A bf16 CUDA tensor reaches only a bf16 kernel: a mix of dtypes, a
    bf16 affine, or fp16 raises."""
    rng = np.random.default_rng(10)
    x, r = _bf16_case(rng, dev, 1, 64, 8, 8)
    aff = _aff(rng, dev, 1, 64)
    wt, bias = _wb(rng, dev, 64, 64, 3)
    ce = cuda_encoder
    with pytest.raises(ValueError):  # a fp32 residual beside bf16 x
        ce.stage_conv(x, aff, wt, bias, res=r.float(), res_aff=aff)
    with pytest.raises(ValueError):  # a bf16 affine
        ce.stage_conv(x, tuple(a.to(BF) for a in aff), wt, bias)
    with pytest.raises(ValueError):  # fp16 activations
        ce.plane_stats(x.half())
    with pytest.raises(ValueError):  # the finish's terms of two dtypes
        ce.stage_finish(x, aff, r.float(), aff, x, aff)
    with pytest.raises(ValueError):  # row 14's operands of two dtypes
        ce.dual_sums(x, x.float())
    with pytest.raises(ValueError):  # fp16 operands
        ce.dual_sums(x.half(), x.half())


# H*W not a multiple of 8 (the scalar path), one plane smaller than the
# block, the recipe's 230,400-pixel planes (2 of its 12 images).
@pytest.mark.parametrize("shape", [(2, 64, 13, 7), (1, 8, 3, 5),
                                   (2, 64, 320, 720)])
def test_dual_sums_bf16_kernel_matches_plain(dev, shape, monkeypatch):
    """Row 14's bf16 form (training the fused encoder in bf16): fp32 sums
    of the upcast bf16 u and u*v per plane, bitwise repeatable, within
    1e-5 of max(1, |plain|) per pixel (fp32 sums in another order), one
    launch a call, never the plain version."""
    rng = np.random.default_rng(shape[2])
    u = _randn(rng, *shape).to(BF).to(dev)
    v = (_randn(rng, *shape) * 2 + 0.5).to(BF).to(dev)
    k1, k2, want = _twice_bf16(cuda_encoder.dual_sums, (u, v), {},
                               monkeypatch)
    n = shape[2] * shape[3]
    for a, b, w in zip(k1, k2, want):
        assert torch.equal(a, b) and a.dtype == w.dtype == torch.float32
        scale = max(1.0, float((w / n).abs().max()))
        assert float(((a.cpu() - w) / n).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("ds", [2, 3])
def test_fused_encoder_bf16_on_card_never_runs_plain(dev, ds, monkeypatch):
    """``fused_encoder=True`` in bf16 on CUDA tensors: every plain version
    patched to raise, the model runs with each bf16 kernel counted per
    row, and the card's encoder outputs match the CPU's (plain versions)
    within the flips of conv sums taken in another order, spread through
    the stages (fnet's feature maps within 24 ulps of max(1, |cpu|), as
    tests/test_torch_port_enc_bf16.py holds the port against JAX)."""
    cfg = RAFTStereoConfig(n_gru_layers=3, hidden_dims=(32, 32, 32),
                           corr_levels=2, corr_radius=2, fused_encoder=True,
                           n_downsample=ds, compute_dtype="bfloat16",
                           corr_dtype="bfloat16")
    gpu = RAFTStereo(cfg, device=dev, seed=4)
    cpu = RAFTStereo(cfg, device="cpu", seed=4)
    rng = np.random.default_rng(ds)
    hw = (32, 48) if ds == 2 else (32, 64)
    img = torch.from_numpy(rng.uniform(-1, 1, (2, 3) + hw).astype(
        np.float32)).to(BF)
    with torch.inference_mode():
        want = cpu.fnet(img)

    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card path")

    for name in ("conv_plain", "entry_plain", "finish_plain", "stats_plain",
                 "prep"):
        monkeypatch.setattr(cuda_encoder, name, boom)
    for fn in cuda_encoder.WRAPPERS:
        fn.launches = 0
    with torch.inference_mode():
        got = gpu.fnet(img.to(dev))
    lo, up = gpu(*(torch.from_numpy(rng.uniform(0, 255, (1,) + hw + (3,))
                                    .astype(np.float32)).to(dev)
                   for _ in range(2)), iters=2)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in cuda_encoder.WRAPPERS}
    assert launches == {"stem_conv7": 3 * (ds == 2),
                        "stem_conv7_s2": 3 * (ds == 3), "stage_conv": 12,
                        "plane_stats": 0, "stage_finish": 3, "l2_entry": 3,
                        "l2_conv": 9, "l2_finish": 3, "dual_sums": 0}
    assert got.dtype == BF and bool(torch.isfinite(up).all())
    ulps = ((got.cpu().float() - want.float()).abs()
            / want.float().abs().clamp_min(1.0)).max()
    assert float(ulps) <= 24 * 2.0 ** -7


class _Pin(torch.autograd.Function):
    """Forward: the pinned value; backward: its cotangent to both the
    output it replaces (so the encoder's backward runs on it) and the
    pinned leaf."""

    @staticmethod
    def forward(ctx, out, pinned):
        return pinned.detach().clone()

    @staticmethod
    def backward(ctx, g):
        return g, g


# The bf16 step card vs CPU (TINY widths, 32x48, 3 iterations), the card's
# encoder outputs pinned in both with their gradients flowing through the
# encoders: each 2-norm distance card-CPU at most 0.7 of the CPU's
# bf16-vs-fp32 distance (chip_smoke.py's BF16_STEP_SHARE) for the
# predictions, the non-encoder gradients, the cotangents at the encoders'
# outputs and the fused encoders' gradients.  Measured (NVIDIA H100 80GB
# HBM3, 700 W; bf16 / fp32 correlation): 0.058 / 0.053, 0.13 / 0.095,
# 0.15 / 0.11, 0.33 / 0.29.  Unpinned, the whole step read 0.73-0.84:
# the encoders' forward flips, grown by the GRU.


@pytest.mark.parametrize("corr_dtype", ["bfloat16", "float32"])
def test_fused_bf16_train_step_on_card(dev, corr_dtype, monkeypatch):
    """A bf16 train step with ``fused_encoder=True`` on the card, every
    plain version patched to raise: fnet's 2 images take the conv1 stage
    and its bf16 backward with 5 dual sums (row 14's bf16 form); the
    gradients are finite; the card's step lies nearer the CPU's bf16 step
    (plain versions) than the CPU's fp32 step does (the shares above), so
    a card step that ran fp32 fails."""
    from raftstereo_tpu_torch.train.loss import sequence_loss

    cfg = RAFTStereoConfig(n_gru_layers=3, hidden_dims=(32, 32, 32),
                           corr_levels=2, corr_radius=2, fused_encoder=True,
                           compute_dtype="bfloat16", corr_dtype=corr_dtype)
    rng = np.random.default_rng(7)
    batch = [torch.from_numpy(rng.uniform(0, 255, (1, 32, 48, 3))
                              .astype(np.float32)) for _ in range(2)]
    batch += [torch.from_numpy(-rng.uniform(1, 20, (1, 32, 48, 1))
                               .astype(np.float32)), torch.ones(1, 32, 48)]
    card = RAFTStereo(cfg, device=dev, seed=4)
    with torch.no_grad():
        img = [(2.0 * (t / 255.0) - 1.0).to(torch.bfloat16).permute(
            0, 3, 1, 2).contiguous().to(dev) for t in batch[:2]]
        pinned = (card.cnet(img[0]), card.fnet(torch.cat(img)))

    def step(m, device, dtype):
        leaves = [[t.detach().to(device, dtype).clone().requires_grad_()
                   for t in lvl] for lvl in pinned[0]]
        fm = pinned[1].detach().to(device, dtype).clone().requires_grad_()
        cnet, fnet = m.cnet.forward, m.fnet.forward
        m.cnet.forward = lambda x: [[_Pin.apply(o, p) for o, p in
                                     zip(lo, lp)]
                                    for lo, lp in zip(cnet(x), leaves)]
        m.fnet.forward = lambda x: _Pin.apply(fnet(x), fm)
        preds = m(*(t.to(device) for t in batch[:2]), iters=3,
                  test_mode=False)
        loss, _ = sequence_loss(preds, *(t.to(device) for t in batch[2:]))
        loss.backward()
        grads = {k: p.grad.float().cpu() for k, p in m.named_parameters()}
        cots = [t.grad for lvl in leaves for t in lvl] + [fm.grad]
        return dict(
            preds=preds.detach().float().cpu().reshape(-1),
            cots=torch.cat([t.float().cpu().reshape(-1) for t in cots]),
            grads=torch.cat([grads[k].reshape(-1) for k in sorted(grads)
                             if not k.startswith(("cnet.", "fnet."))]),
            enc=torch.cat([grads[k].reshape(-1) for k in sorted(grads)
                           if k.startswith(("cnet.", "fnet."))]))

    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card path")

    with monkeypatch.context() as mp:
        for name in ("conv_plain", "entry_plain", "finish_plain",
                     "stats_plain", "dual_sums_plain", "prep"):
            mp.setattr(cuda_encoder, name, boom)
        for fn in cuda_encoder.WRAPPERS:
            fn.launches = 0
        got = step(card, dev, torch.bfloat16)
        torch.cuda.synchronize()
        assert cuda_encoder.dual_sums.launches == 5
        assert cuda_encoder.stem_conv7.launches == 2
    cpu = RAFTStereo(cfg, device="cpu", seed=4)
    f32 = RAFTStereo(dataclasses.replace(
        cfg, compute_dtype="float32", corr_dtype="float32"), device="cpu",
        seed=4)
    want, ref = step(cpu, "cpu", torch.bfloat16), step(f32, "cpu",
                                                      torch.float32)
    assert all(bool(torch.isfinite(t).all()) for t in got.values())
    shares = {k: float((got[k] - want[k]).norm() / (ref[k] - want[k]).norm())
              for k in got}
    assert all(v <= 0.7 for v in shares.values()), shares


# ------------------------------------ precomputed-volume lookup, int8 volume

def _same_bits(a, b):
    """Equal NaN positions and equal values elsewhere."""
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)))


def _vol_inputs(dev, rng, b, h, w, levels, radius, nan=True):
    st = build_corr_state(_randn(rng, b, h, w, 256).to(dev),
                          _randn(rng, b, h, w, 256).to(dev), levels,
                          "pallas")
    x = np.arange(w, dtype=np.float32) + rng.uniform(-w / 2, 6, (b, h, w))
    x[0, 0, :3] = [-200.5, w + 200.25, 1e6]
    if nan:
        x[-1, -1, -1] = np.nan
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    g = _randn(rng, b, h, w, levels * (2 * radius + 1)).to(dev)
    return st, x, g


@pytest.mark.parametrize("shape,levels,radius", [
    ((2, 11, 20), 4, 4), ((1, 36, 240), 4, 4), ((1, 2, 4), 4, 2)],
    ids=["hostile", "serving_rows", "zero_width_level"])
def test_vol_lookup_kernel_matches_plain(dev, shape, levels, radius):
    """Row 5 against its plain version: bitwise (each product and the sum
    rounded once in both), NaN where the coordinate is NaN."""
    rng = np.random.default_rng(10)
    st, x, _ = _vol_inputs(dev, rng, *shape, levels, radius,
                           nan=shape[2] > 4)
    before = cuda_vol.vol_lookup.launches
    got = cuda_vol.vol_lookup(st.vcat, st.widths, x, radius)
    again = cuda_vol.vol_lookup(st.vcat, st.widths, x, radius)
    assert cuda_vol.vol_lookup.launches == before + 2
    want = cuda_vol.vol_lookup_plain(st.vcat, st.widths, x, radius)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    assert _int_bits(got, again)
    if shape[2] > 4:
        assert torch.isnan(got[-1, -1, -1]).all()


def _int_bits(a, b):
    """NaN at the same places and the same bits elsewhere (-0 apart from
    +0)."""
    ok = ~a.isnan()
    return (torch.equal(ok, ~b.isnan())
            and torch.equal(a[ok].view(torch.int32), b[ok].view(torch.int32)))


# Row 5's hostile cases: (widths, radius, misaligned vcat).  The windowed
# instances take radius 0..4; radius 8 takes the per-tap form.
VOL_FWD_HOSTILE = [
    pytest.param((64, 32, 16, 8), 4, False, id="recipe_levels"),
    pytest.param((64, 32, 16, 8), 4, True, id="misaligned_vcat"),
    pytest.param((64, 32, 0, 8), 2, False, id="zero_width_level"),
    pytest.param((64, 32), 0, True, id="radius0"),
    pytest.param((64, 32, 16, 8, 4, 2, 1, 0), 8, False,
                 id="radius8_8_levels"),
    pytest.param((64, 32, 16, 8, 4, 2, 1, 0), 3, True, id="8_levels"),
]


@pytest.mark.parametrize("widths,radius,misaligned", VOL_FWD_HOSTILE)
def test_vol_lookup_hostile_bitwise(dev, widths, radius, misaligned):
    """Row 5 on coordinates whose rounded taps cross an integer (x =
    127.99999 and 0.99999994: a window of K+2 columns and one whose
    second tap repeats the first's floor), NaN, +-inf, +-1e30, integers and
    half-integers, coordinates past both edges, and a volume whose rows
    start at every 4-byte alignment: bitwise equal to the plain version
    and to a second call."""
    rng = np.random.default_rng(60 + radius)
    b, h, w1 = 2, 5, 64
    w2 = sum(widths)
    x = (np.arange(w1) - rng.uniform(0, 40, (b, h, w1))).astype(np.float32)
    x[0, 0, :14] = [np.nan, np.inf, -np.inf, 1e30, -1e30, 127.99999,
                    0.99999994, 63.99999, 2.0 ** 24 + 2, -200.5, w1 + 300.25,
                    radius + 0.5, -radius - 1.0000001, 31.999998]
    x[0, 1] = np.arange(w1) * 0.5 - 8.0    # integers and half-integers
    x[1, 2] = np.arange(w1) - 0.0000019    # just below each integer
    base = _randn(rng, b * h * w1 * w2 + 1).to(dev)
    vcat = base[int(misaligned):][:b * h * w1 * w2].view(b, h, w1, w2)
    x = torch.from_numpy(x).to(dev)
    before = cuda_vol.vol_lookup.launches
    k1 = cuda_vol.vol_lookup(vcat, widths, x, radius)
    k2 = cuda_vol.vol_lookup(vcat, widths, x, radius)
    assert cuda_vol.vol_lookup.launches == before + 2
    want = cuda_vol.vol_lookup_plain(vcat, widths, x, radius)
    torch.cuda.synchronize()
    assert _int_bits(k1, want) and _int_bits(k1, k2)
    assert bool(want.isnan().any()) and bool((want != 0).any())


@pytest.mark.parametrize("shape,levels,radius", [
    ((2, 11, 20), 4, 4), ((6, 80, 180), 4, 4), ((1, 2, 4), 4, 2)],
    ids=["hostile", "training", "zero_width_level"])
def test_vol_lookup_backward_kernel_matches_plain(dev, shape, levels, radius):
    """Row 6: two calls bitwise equal (no atomics), and bitwise equal to
    the plain version (the same ordered sum), NaN segments included."""
    rng = np.random.default_rng(11)
    st, x, g = _vol_inputs(dev, rng, *shape, levels, radius,
                           nan=shape[2] > 4)
    before = cuda_vol.vol_lookup_backward.launches
    k1 = cuda_vol.vol_lookup_backward(x, g, st.widths, radius)
    k2 = cuda_vol.vol_lookup_backward(x, g, st.widths, radius)
    assert cuda_vol.vol_lookup_backward.launches == before + 2
    want = cuda_vol.vol_lookup_backward_plain(x, g, st.widths, radius)
    torch.cuda.synchronize()
    assert k1.shape == st.vcat.shape
    assert _same_bits(k1, k2) and _same_bits(k1, want)
    assert bool(torch.isnan(k1).any()) == (shape[2] > 4)


# Row 6's non-finite and far cases: (radius, widths, seed).
VOL_BWD_NONFINITE = [pytest.param(4, (180, 90, 45, 22), 40, id="recipe"),
                     pytest.param(0, (60, 30), 41, id="radius0"),
                     pytest.param(8, (64, 32, 16, 8, 4, 2, 1, 0), 42,
                                  id="radius8_8_levels"),
                     pytest.param(1, (2,), 43, id="one_level_2_wide")]


@pytest.mark.parametrize("radius,widths,seed", VOL_BWD_NONFINITE)
def test_vol_lookup_backward_nonfinite_bitwise(dev, radius, widths, seed):
    """Row 6 on NaN coordinates, +-inf and NaN cotangents, -0 and
    subnormal cotangents, integer and half-integer coordinates and
    coordinates far past both edges (up to +-1e30 and +-inf): bitwise
    equal to the plain version's dense form and to a second call."""
    rng = np.random.default_rng(seed)
    b, h, w1 = 2, 5, 64
    k = 2 * radius + 1
    x = (np.arange(w1) - rng.uniform(0, 40, (b, h, w1))).astype(np.float32)
    x[0, 0, :10] = [np.nan, -200.5, w1 + 300.25, 1e7, -1e7, 1e30, -1e30,
                    np.inf, -np.inf, 2.0 ** 24 + 2]
    x[0, 1] = np.arange(w1) * 0.5 - 8.0    # integers and half-integers
    g = rng.normal(size=(b, h, w1, len(widths) * k)).astype(np.float32)
    x[0, 2, 3], x[0, 2, 9] = radius + 0.5, 0.25 - radius
    g[0, 2, 3, 0] = np.inf        # level 0's first tap: columns 0 and 1
    g[0, 2, 9, k - 1] = -np.inf   # level 0's last tap: columns 0 and 1
    g[1, 0, 5, k // 2] = np.nan
    g[1, 1, :, 0] = -0.0
    g[1, 2, :, -1] = 1e-41
    x = torch.from_numpy(x).to(dev)
    g = torch.from_numpy(g).to(dev)
    k1 = cuda_vol.vol_lookup_backward(x, g, widths, radius)
    k2 = cuda_vol.vol_lookup_backward(x, g, widths, radius)
    want = cuda_vol.vol_lookup_backward_plain(x, g, widths, radius)
    torch.cuda.synchronize()
    for a in (k2, want):   # NaN where plain is NaN, the same bits elsewhere
        ok = ~a.isnan()
        assert torch.equal(k1.isnan(), ~ok)
        assert torch.equal(k1[ok].view(torch.int32), a[ok].view(torch.int32))
    assert bool(want.isnan().any()) and bool(want.isinf().any())


@pytest.mark.parametrize("b,h,w1,w2,c", [
    (2, 3, 7, 9, 16), (1, 5, 70, 130, 256), (1, 144, 240, 240, 256)],
    ids=["tiny", "ragged_tiles", "serving"])
def test_int8_volume_kernel_matches_plain(dev, b, h, w1, w2, c):
    """Row 7: bitwise equal to the plain version (exact integer sums, the
    same three rounded multiplies)."""
    rng = np.random.default_rng(w1)
    q1, s1 = quant.quantize_rows(_randn(rng, b, h, w1, c).to(dev))
    q2, s2 = quant.quantize_rows(3 * _randn(rng, b, h, w2, c).to(dev))
    before = quant.int8_corr_volume.launches
    got = quant.int8_corr_volume(q1, s1, q2, s2)
    again = quant.int8_corr_volume(q1, s1, q2, s2)
    assert quant.int8_corr_volume.launches == before + 2
    want = quant.int8_volume_plain(q1, s1, q2, s2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert _int_bits(got, want) and _int_bits(got, again)


@pytest.mark.parametrize("w1,w2,c", [(9, 9, 16), (130, 130, 48),
                                     (240, 9, 48), (241, 130, 16),
                                     (48, 240, 272)],
                         ids=["c16_w9", "c48_w130", "c48_w2_9", "c16_w241",
                              "c272_two_k_chunks"])
def test_int8_volume_hostile_bitwise(dev, w1, w2, c):
    """Row 7 on the full int8 range: rows of +127, -127 and -128 on every
    channel (the extreme sums, -128 x -128 included), random codes in
    [-128, 127], a zero scale (signed zeros), ragged W1 and W2 and C not a
    multiple of the 32-deep k-step: bitwise equal to the plain version
    (int32 views, -0 apart from +0) and to a second call."""
    rng = np.random.default_rng(w1 + w2 + c)
    b, h = 1, 3
    q1 = rng.integers(-128, 128, (b, h, w1, c)).astype(np.int8)
    q2 = rng.integers(-128, 128, (b, h, w2, c)).astype(np.int8)
    for q in (q1, q2):
        q[0, 0, 0], q[0, 0, 1], q[0, 0, -1] = 127, -127, -128
    s1 = rng.uniform(1e-3, 0.1, (b, h, w1)).astype(np.float32)
    s2 = rng.uniform(1e-3, 0.1, (b, h, w2)).astype(np.float32)
    s1[0, 1, w1 // 2] = 0.0
    s2[0, 2, :] = 0.0
    q1, q2, s1, s2 = (torch.from_numpy(a).to(dev) for a in (q1, q2, s1, s2))
    before = quant.int8_corr_volume.launches
    k1 = quant.int8_corr_volume(q1, s1, q2, s2)
    k2 = quant.int8_corr_volume(q1, s1, q2, s2)
    assert quant.int8_corr_volume.launches == before + 2
    want = quant.int8_volume_plain(q1, s1, q2, s2)
    torch.cuda.synchronize()
    assert _int_bits(k1, want) and _int_bits(k1, k2)
    one = torch.ones((1,), device=dev)
    acc = quant.int8_volume_plain(q1[0, 0, -1:], one, q2[0, 0, -1:], one)
    assert float(acc) == np.float32(128 * 128 * c) * np.float32(
        quant.inv_sqrt_channels(c))    # -128 x -128 on every channel
    assert bool(torch.signbit(want[want == 0]).any())  # a -0 held


def test_vol_wrappers_raise_instead_of_falling_back(dev):
    rng = np.random.default_rng(12)
    st, x, g = _vol_inputs(dev, rng, 1, 2, 8, 2, 2, nan=False)
    with pytest.raises(ValueError):  # x on the CPU, the volume on the card
        cuda_vol.vol_lookup(st.vcat, st.widths, x.cpu(), 2)
    with pytest.raises(ValueError):  # float64
        cuda_vol.vol_lookup(st.vcat.double(), st.widths, x, 2)
    with pytest.raises(ValueError):  # widths that do not sum to W2
        cuda_vol.vol_lookup(st.vcat, (8, 3), x, 2)
    with pytest.raises(ValueError):  # a cotangent of the wrong width
        cuda_vol.vol_lookup_backward(x, g[..., :9].contiguous(), st.widths, 2)
    with pytest.raises(ValueError):  # a non-contiguous cotangent
        cuda_vol.vol_lookup_backward(x, g.transpose(1, 2), st.widths, 2)
    q, s = quant.quantize_rows(_randn(rng, 1, 2, 8, 24).to(dev))
    with pytest.raises(ValueError):  # C=24 is not a multiple of 16
        quant.int8_corr_volume(q, s, q, s)
    q, s = quant.quantize_rows(_randn(rng, 1, 2, 8, 32).to(dev))
    with pytest.raises(ValueError):  # int32 codes
        quant.int8_corr_volume(q.int(), s, q, s)
    with pytest.raises(ValueError):  # scales on the CPU
        quant.int8_corr_volume(q, s.cpu(), q, s)


# ---------------------------------------- rows 5 and 7, bf16 forms

@pytest.mark.parametrize("shape,levels,radius", [
    ((2, 11, 20), 4, 4), ((1, 36, 240), 4, 4), ((1, 2, 4), 4, 2)],
    ids=["hostile", "serving_rows", "zero_width_level"])
def test_vol_lookup_bf16_kernel_matches_plain(dev, shape, levels, radius):
    """Row 5 over a bf16 volume pyramid: fp32 out, bitwise equal to the
    plain version and to a second call, NaN where the coordinate is
    NaN."""
    rng = np.random.default_rng(70)
    b, h, w = shape
    st = build_corr_state(_randn(rng, b, h, w, 256).to(dev),
                          _randn(rng, b, h, w, 256).to(dev), levels,
                          "pallas", corr_dtype=torch.bfloat16)
    assert st.vcat.dtype == torch.bfloat16
    x = np.arange(w, dtype=np.float32) + rng.uniform(-w / 2, 6, (b, h, w))
    x[0, 0, :3] = [-200.5, w + 200.25, 1e6]
    if w > 4:
        x[-1, -1, -1] = np.nan
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    before = cuda_vol.vol_lookup.launches
    got = cuda_vol.vol_lookup(st.vcat, st.widths, x, radius)
    again = cuda_vol.vol_lookup(st.vcat, st.widths, x, radius)
    assert cuda_vol.vol_lookup.launches == before + 2
    want = cuda_vol.vol_lookup_plain(st.vcat, st.widths, x, radius)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert _int_bits(got, want) and _int_bits(got, again)


@pytest.mark.parametrize("widths,radius,misaligned", VOL_FWD_HOSTILE)
def test_vol_lookup_bf16_hostile_bitwise(dev, widths, radius, misaligned):
    """Row 5's hostile coordinates over a bf16 volume whose rows start at
    every 2-byte alignment of a 16-byte chunk (shifts 0..7, the barrel
    shifter's every stage): bitwise equal to plain and repeatable."""
    rng = np.random.default_rng(80 + radius)
    b, h, w1 = 2, 5, 64
    w2 = sum(widths)
    x = (np.arange(w1) - rng.uniform(0, 40, (b, h, w1))).astype(np.float32)
    x[0, 0, :14] = [np.nan, np.inf, -np.inf, 1e30, -1e30, 127.99999,
                    0.99999994, 63.99999, 2.0 ** 24 + 2, -200.5, w1 + 300.25,
                    radius + 0.5, -radius - 1.0000001, 31.999998]
    x[0, 1] = np.arange(w1) * 0.5 - 8.0
    x[1, 2] = np.arange(w1) - 0.0000019
    x = torch.from_numpy(x).to(dev)
    base = _randn(rng, b * h * w1 * w2 + 8).to(dev).to(torch.bfloat16)
    for shift in (range(8) if misaligned else (0,)):
        vcat = base[shift:][:b * h * w1 * w2].view(b, h, w1, w2)
        k1 = cuda_vol.vol_lookup(vcat, widths, x, radius)
        k2 = cuda_vol.vol_lookup(vcat, widths, x, radius)
        want = cuda_vol.vol_lookup_plain(vcat, widths, x, radius)
        torch.cuda.synchronize()
        assert _int_bits(k1, want) and _int_bits(k1, k2), shift
        assert bool(want.isnan().any()) and bool((want != 0).any())


def _bf16_bits(a, b):
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("b,h,w1,w2,c", [
    (2, 3, 7, 9, 16), (1, 5, 70, 130, 256), (1, 3, 241, 130, 48),
    (1, 144, 240, 240, 256)],
    ids=["tiny", "ragged_tiles", "ragged_w1_c48", "serving"])
def test_int8_volume_bf16_kernel_matches_plain(dev, b, h, w1, w2, c):
    """Row 7 with a bf16 volume: bitwise equal to the plain version (the
    fp32 epilogue rounded once) and to a second call, in 16-byte rows of
    8 values where W2 % 8 == 0 and scalar stores otherwise; the fp32 form
    on the same inputs rounds to the same bits."""
    rng = np.random.default_rng(w1 + 7)
    q1, s1 = quant.quantize_rows(_randn(rng, b, h, w1, c).to(dev))
    q2, s2 = quant.quantize_rows(3 * _randn(rng, b, h, w2, c).to(dev))
    bf = torch.bfloat16
    before = quant.int8_corr_volume.launches
    got = quant.int8_corr_volume(q1, s1, q2, s2, out_dtype=bf)
    again = quant.int8_corr_volume(q1, s1, q2, s2, out_dtype=bf)
    assert quant.int8_corr_volume.launches == before + 2
    want = quant.int8_volume_plain(q1, s1, q2, s2, out_dtype=bf)
    fp32 = quant.int8_corr_volume(q1, s1, q2, s2)
    torch.cuda.synchronize()
    assert got.dtype == bf and got.shape == (b, h, w1, w2)
    assert _bf16_bits(got, want) and _bf16_bits(got, again)
    assert _bf16_bits(got, fp32.to(bf))


@pytest.mark.parametrize("kw,want", [
    (dict(corr_implementation="pallas"),
     dict(vol_lookup=3, int8_corr_volume=0, gru_update=3, alt_corr=0)),
    (dict(corr_quant=True),
     dict(vol_lookup=3, int8_corr_volume=1, gru_update=3, alt_corr=0)),
    (dict(corr_quant=True, gru_backend="xla"),
     dict(vol_lookup=3, int8_corr_volume=1, gru_update=0, alt_corr=0))],
    ids=["fast_pallas", "turbo", "turbo_xla"])
def test_bf16_volume_serving_on_card_never_runs_plain(dev, kw, want,
                                                      monkeypatch):
    """The bf16 ``pallas`` volume and the int8 tier on the card with the
    volume kernels' and the update's plain versions patched to raise:
    each iteration launches its path's kernels, the int8 volume once a
    forward, and the disparities are finite fp32 and nearer the CPU's
    forward fed the card's encoder outputs and int8 codes than 0.7 of the
    CPU's bf16-vs-fp32 distance (2-norms, the share ``chip_smoke.py``'s
    bf16 step holds)."""
    cfg = RAFTStereoConfig(n_gru_layers=3, hidden_dims=(32, 32, 32),
                           corr_levels=2, corr_radius=2,
                           compute_dtype="bfloat16", corr_dtype="bfloat16",
                           **kw)
    model = RAFTStereo(cfg, device=dev, seed=4)
    cpu = RAFTStereo(cfg, device="cpu", seed=4)
    rng = np.random.default_rng(23)
    imgs = [torch.from_numpy(rng.uniform(0, 255, (1, 32, 48, 3))
                             .astype(np.float32)) for _ in range(2)]
    seen, codes, real = {}, [], quant.quantize_rows
    cnet, fnet = model.cnet.forward, model.fnet.forward
    monkeypatch.setattr(model.cnet, "forward",
                        lambda x: seen.setdefault("cnet", cnet(x)))
    monkeypatch.setattr(model.fnet, "forward",
                        lambda x: seen.setdefault("fnet", fnet(x)))
    monkeypatch.setattr(quant, "quantize_rows",
                        lambda x: codes.append(real(x)) or codes[-1])

    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card path")

    for mod, name in ((cuda_vol, "vol_lookup_plain"),
                      (quant, "int8_volume_plain"),
                      (cuda_gru, "gru_update_plain")):
        monkeypatch.setattr(mod, name, boom)
    fns = dict(vol_lookup=cuda_vol.vol_lookup,
               int8_corr_volume=quant.int8_corr_volume,
               gru_update=cuda_gru.gru_update, alt_corr=cuda_alt.alt_corr)
    for f in fns.values():
        f.launches = 0
    lo, up = model(*(i.to(dev) for i in imgs), iters=3)
    torch.cuda.synchronize()
    assert {k: f.launches for k, f in fns.items()} == want
    assert lo.dtype == up.dtype == torch.float32
    assert bool(torch.isfinite(up).all())
    monkeypatch.undo()
    pinned = iter([tuple(t.cpu() for t in c) for c in codes])
    monkeypatch.setattr(quant, "quantize_rows", lambda x: next(pinned))
    cpu.cnet.forward = lambda x: [[t.cpu() for t in lvl]
                                  for lvl in seen["cnet"]]
    cpu.fnet.forward = lambda x: seen["fnet"].cpu()
    lo_c, _ = cpu(*imgs, iters=3)
    f32 = RAFTStereo(RAFTStereoConfig(n_gru_layers=3, hidden_dims=(32, 32, 32),
                                      corr_levels=2, corr_radius=2,
                                      **dict(kw, corr_quant=False)),
                     device="cpu", seed=4)
    lo_f, _ = f32(*imgs, iters=3)
    assert (float((lo.cpu() - lo_c).norm())
            <= 0.7 * float((lo_c - lo_f).norm()))


@pytest.mark.parametrize("kw", [dict(corr_implementation="pallas"),
                                dict(corr_quant=True),
                                dict(corr_implementation="reg"),
                                dict(corr_implementation="alt")],
                         ids=["pallas", "corr_quant", "reg", "alt"])
def test_corr_backends_on_card_never_run_plain(dev, kw, monkeypatch):
    """Each backend's forward on the card with the volume kernels' plain
    versions patched to raise: launches counted per request, and the
    result within the parity thresholds of the CPU forward.  With
    ``corr_quant`` the card's and the CPU's features differ by fp32
    rounding, which moves a few int8 codes across a rounding boundary;
    there the card must be closer to the CPU's quantized forward than
    the CPU's fp32 forward is (the whole quantization effect)."""
    cfg = RAFTStereoConfig(n_gru_layers=3, hidden_dims=(32, 32, 32),
                           corr_levels=2, corr_radius=2, **kw)
    gpu = RAFTStereo(cfg, device=dev, seed=4)
    cpu = RAFTStereo(cfg, device="cpu", seed=4)
    rng = np.random.default_rng(13)
    imgs = [torch.from_numpy(rng.uniform(0, 255, (1, 32, 48, 3))
                             .astype(np.float32)) for _ in range(2)]
    lo_c, up_c = cpu(*imgs, iters=3)

    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card path")

    monkeypatch.setattr(cuda_vol, "vol_lookup_plain", boom)
    monkeypatch.setattr(quant, "int8_volume_plain", boom)
    counted = (cuda_vol.vol_lookup, quant.int8_corr_volume, cuda_alt.alt_corr)
    for fn in counted:
        fn.launches = 0
    lo_g, up_g = gpu(*(i.to(dev) for i in imgs), iters=3)
    torch.cuda.synchronize()
    vol = "corr_quant" in kw or kw.get("corr_implementation") == "pallas"
    assert [fn.launches for fn in counted] == [
        3 * vol, int("corr_quant" in kw), 0]
    if "corr_quant" in kw:
        fp32 = RAFTStereo(RAFTStereoConfig(
            n_gru_layers=3, hidden_dims=(32, 32, 32), corr_levels=2,
            corr_radius=2), device="cpu", seed=4)
        lo_f, up_f = fp32(*imgs, iters=3)
        for card, want, unquantized in ((lo_g, lo_c, lo_f),
                                        (up_g, up_c, up_f)):
            err = float((card.cpu() - want).abs().max())
            assert err < float((unquantized - want).abs().max())
        return
    torch.testing.assert_close(lo_g.cpu(), lo_c, rtol=0, atol=2e-3)
    torch.testing.assert_close(up_g.cpu(), up_c, rtol=0, atol=5e-3)


def test_pallas_train_step_on_card_matches_cpu(dev, monkeypatch):
    """A ``pallas`` train step on the card (kernels; the backward's plain
    version patched to raise) against the CPU: loss within 1e-4
    relative, every gradient within 1e-3 of the largest CPU entry, on
    the inputs of ``test_train_step_on_card_matches_cpu``.  The gradient
    gap is set by the random-weight GRU's sensitivity to fp32 rounding,
    which moves with the inputs for every backend, the kernel-free
    ``reg`` lookup included."""
    from raftstereo_tpu_torch.train.loss import sequence_loss

    cfg = RAFTStereoConfig(n_gru_layers=3, hidden_dims=(32, 32, 32),
                           corr_levels=2, corr_radius=2,
                           corr_implementation="pallas")
    rng = np.random.default_rng(6)
    batch = [torch.from_numpy(rng.uniform(0, 255, (1, 32, 48, 3))
                              .astype(np.float32)) for _ in range(2)]
    batch += [torch.from_numpy(-rng.uniform(1, 20, (1, 32, 48, 1))
                               .astype(np.float32)), torch.ones(1, 32, 48)]
    out = []
    for device in (torch.device("cpu"), dev):
        if device.type == "cuda":
            def boom(*a, **k):
                raise AssertionError("a plain version ran on the card path")

            monkeypatch.setattr(cuda_vol, "vol_lookup_backward_plain", boom)
            cuda_vol.vol_lookup_backward.launches = 0
        m = RAFTStereo(cfg, device=device, seed=4)
        preds = m(*(t.to(device) for t in batch[:2]), iters=3,
                  test_mode=False)
        loss, _ = sequence_loss(preds, *(t.to(device) for t in batch[2:]))
        loss.backward()
        out.append((float(loss.detach()),
                    {k: p.grad.cpu() for k, p in m.named_parameters()}))
    assert cuda_vol.vol_lookup_backward.launches == 3
    (lc, gc), (lg, gg) = out
    assert lg == pytest.approx(lc, rel=1e-4)
    gmax = max(float(t.abs().max()) for t in gc.values())
    for k in gc:
        assert float((gg[k] - gc[k]).abs().max()) <= 1e-3 * gmax, k


# ----------------------------------------------------------------- bf16

def _bf16_ulps(got, want):
    """Largest difference in bf16 ulps of max(1, |want|) (2^-7 each),
    NaN positions equal."""
    got, want = got.float(), want.float()
    assert torch.equal(got.isnan(), want.isnan())
    ok = ~want.isnan()
    return float(((got[ok] - want[ok]).abs()
                   / want[ok].abs().clamp_min(1.0)).max()) * 2 ** 7


def _bf16_lookup_inputs(dev, fmap_dtype):
    rng = np.random.default_rng(20)
    b, h, w = 2, 11, 20
    st = build_corr_state(_randn(rng, b, h, w, 256).to(dev),
                          _randn(rng, b, h, w, 256).to(dev), 4,
                          corr_dtype=fmap_dtype)
    x = np.arange(w, dtype=np.float32) + rng.uniform(-14, 10, (b, h, w))
    x[0, 0, :3] = [-200.5, w + 200.25, 1e6]
    x[1, 3, 4] = np.nan
    return st, torch.from_numpy(x.astype(np.float32)).to(dev)


@pytest.mark.parametrize("fmap_dtype", [torch.float32, torch.bfloat16])
def test_alt_corr_bf16_kernel_matches_plain(dev, fmap_dtype):
    """Row 1's bf16 output form (bf16 or fp32 feature maps): within one
    bf16 ulp of the plain version (fp32 sums in another order, rounded
    once), NaN where the coordinate is NaN."""
    st, x = _bf16_lookup_inputs(dev, fmap_dtype)
    before = cuda_alt.alt_corr.launches
    got = cuda_alt.alt_corr(st.fmap1, st.f2cat, st.widths, x, 4,
                            torch.bfloat16)
    assert cuda_alt.alt_corr.launches == before + 1
    want = cuda_alt.alt_corr_plain(st.fmap1, st.f2cat, st.widths, x, 4,
                                   torch.bfloat16)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got, want) <= 1.0


@pytest.mark.parametrize("fmap_dtype", [torch.float32, torch.bfloat16])
def test_alt_corr_epi_kernel_matches_plain(dev, fmap_dtype):
    """Row 18: within 2 bf16 ulps of the plain version (a column rounded
    at a boundary moves the 36-term product), NaN where the coordinate is
    NaN, zeros from the relu."""
    st, x = _bf16_lookup_inputs(dev, fmap_dtype)
    rng = np.random.default_rng(21)
    ew = (_randn(rng, 36, 64) / 6).to(dev, torch.bfloat16)
    eb = (_randn(rng, 64) / 10).to(dev, torch.bfloat16)
    before = cuda_alt.alt_corr_epi.launches
    got = cuda_alt.alt_corr_epi(st.fmap1, st.f2cat, st.widths, x, 4, ew, eb)
    assert cuda_alt.alt_corr_epi.launches == before + 1
    want = cuda_alt.alt_corr_epi_plain(st.fmap1, st.f2cat, st.widths, x, 4,
                                       ew, eb)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (2, 11, 20, 64)
    assert _bf16_ulps(got, want) <= 2.0
    assert (got == 0).any() and (got > 0).any()
    assert torch.isnan(got[1, 3, 4]).all()
    got2 = cuda_alt.alt_corr_epi(st.fmap1, st.f2cat, st.widths, x, 4, ew, eb)
    assert _same_bits(got, got2)


@pytest.mark.parametrize("field,fmap_dtype", [
    ("jump", torch.float32), ("jump", torch.bfloat16),
    ("smooth", torch.float32), ("smooth", torch.bfloat16),
    ("nan", torch.bfloat16)],
    ids=["wide_span", "wide_span_bf16", "smooth", "smooth_bf16", "nan_bf16"])
def test_alt_corr_epi_kernel_serving_fields(dev, field, fmap_dtype):
    """Row 18 at the serving grid (1x144x240, C=256, 4 levels of radius 4)
    on row 1's staged tiles: a field whose jumps outgrow the staging
    buffer (the wide-span path), a smooth one, and the random field with
    NaN and far coordinates; within 2 bf16 ulps of plain, NaN exactly
    where plain has NaN, two calls bitwise equal."""
    rng = np.random.default_rng(23)
    b, h, w = 1, 144, 240
    st = build_corr_state(_randn(rng, b, h, w, 256).to(dev),
                          _randn(rng, b, h, w, 256).to(dev), 4,
                          corr_dtype=fmap_dtype)
    if field == "nan":
        x = np.arange(w, dtype=np.float32) - rng.uniform(0, 60, (b, h, w))
        x[0, ::7, ::11] = np.nan
        x[0, 3, :4] = [-500.0, w + 400.5, np.inf, -np.inf]
        x = torch.from_numpy(x.astype(np.float32)).to(dev)
    else:
        x = _lookup_field(dev, field, b, h, w, rng)
    ew = (_randn(rng, 36, 64) / 6).to(dev, torch.bfloat16)
    eb = (_randn(rng, 64) / 10).to(dev, torch.bfloat16)
    before = cuda_alt.alt_corr_epi.launches
    got = cuda_alt.alt_corr_epi(st.fmap1, st.f2cat, st.widths, x, 4, ew, eb)
    got2 = cuda_alt.alt_corr_epi(st.fmap1, st.f2cat, st.widths, x, 4, ew, eb)
    assert cuda_alt.alt_corr_epi.launches == before + 2
    want = cuda_alt.alt_corr_epi_plain(st.fmap1, st.f2cat, st.widths, x, 4,
                                       ew, eb)
    torch.cuda.synchronize()
    assert _same_bits(got, got2)
    assert _bf16_ulps(got, want) <= 2.0   # NaN positions equal
    if field == "nan":
        assert torch.isnan(got[0, ::7, ::11]).all()
        assert torch.isnan(got[0, 3, 2:4]).all()


# Row 1's outputs on numpy-seeded inputs, one digest per (field, fmap
# dtype), from the kernel as it was before its staging and dot loop moved
# into alt_corr_tile.cuh, measured on an H100 (CUDA 12.8) by
# scripts/row1_digest.py: the shared header left row 1 bitwise unchanged.
ROW1_DIGESTS = {"random_fp32": "95e207a9178831d8",
                "smooth_fp32": "598867e7bba4d336",
                "jump_fp32": "222fce4fd99b16e1",
                "diverged_fp32": "4da9f036368a20a9",
                "random_bf16": "541294ffa9fa69be",
                "smooth_bf16": "f7adae6e2e7ad332",
                "jump_bf16": "e4202c6f9e33cafe",
                "diverged_bf16": "abec6880bba188b3"}


def row1_digest_cases(dev):
    """(case id, thunk) for each row-1 digest case: the serving grid's
    1x144x240 feature maps, fp32 and bf16, out in the fmaps' dtype, on the
    random, smooth, jump and diverged fields."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(41)
        b, h, w = 1, 144, 240
        st = build_corr_state(_randn(rng, b, h, w, 256).to(dev),
                              _randn(rng, b, h, w, 256).to(dev), 4,
                              corr_dtype=dtype)
        for field in ("random", "smooth", "jump", "diverged"):
            if field == "random":
                x = torch.from_numpy((np.arange(w, dtype=np.float32)
                                      - rng.uniform(0, 60, (b, h, w)))
                                     .astype(np.float32)).to(dev)
            else:
                x = _lookup_field(dev, field, b, h, w, rng)
            tag = "bf16" if dtype == torch.bfloat16 else "fp32"
            cases.append((f"{field}_{tag}",
                          lambda st=st, x=x, dtype=dtype: cuda_alt.alt_corr(
                              st.fmap1, st.f2cat, st.widths, x, 4, dtype)))
    return cases


def sha256(t):
    import hashlib
    return hashlib.sha256(t.cpu().contiguous().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()[:16]


def test_alt_corr_bitwise_unchanged_by_the_shared_header(dev):
    """Row 1 after its staging and dot loop moved into alt_corr_tile.cuh
    (shared with row 18): the same output bits as the parent's kernel on
    every digest case, fp32 and bf16."""
    got = {cid: sha256(fn()) for cid, fn in row1_digest_cases(dev)}
    assert got == ROW1_DIGESTS


@pytest.mark.parametrize("n,hd,levels,b,h,w,seed", GRU_CASES)
def test_gru_update_bf16_kernel_matches_plain(dev, n, hd, levels, b, h, w,
                                              seed):
    """Row 2's bf16 form: within 4 bf16 ulps of the plain version on the
    9x13 grids (a conv output rounded at a boundary carries through the
    convs after it); two calls bitwise equal.  On the 37x53 grids (3922
    and 1961 pixels against 234, so more such chains) it is held to
    chip_smoke.py's bound at the serving shapes: 8 ulps, at least 80% of
    the elements equal."""
    bf = torch.bfloat16
    args, wpack = _gru_case(dev, n, hd, levels, b, h, w, 30 + seed, bf)
    hk, dk = cuda_gru.gru_update(*args, wpack)
    hk2, dk2 = cuda_gru.gru_update(*args, wpack)
    hp, dp = cuda_gru.gru_update_plain(*args, wpack)
    torch.cuda.synchronize()
    assert hk.dtype == dk.dtype == bf
    assert torch.equal(hk, hk2) and torch.equal(dk, dk2)
    ulps = 4.0 if h * w <= 9 * 13 else 8.0
    assert _bf16_ulps(hk, hp) <= ulps and _bf16_ulps(dk, dp) <= ulps
    for got, want in ((hk, hp), (dk, dp)):
        assert float((got == want).float().mean()) >= 0.8


@pytest.mark.parametrize("gru_backend,want", [
    ("fused", dict(alt_corr=3, gru_update=3, alt_corr_epi=0)),
    ("xla", dict(alt_corr=0, gru_update=0, alt_corr_epi=3))])
def test_bf16_serving_on_card_never_runs_plain(dev, gru_backend, want,
                                               monkeypatch):
    """A bf16 forward on the card with every bf16 kernel's plain version
    patched to raise: each iteration launches its path's kernels, and the
    disparities are finite fp32."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card path")

    for mod, name in ((cuda_alt, "alt_corr_plain"),
                      (cuda_alt, "alt_corr_epi_plain"),
                      (cuda_gru, "gru_update_plain")):
        monkeypatch.setattr(mod, name, boom)
    cfg = RAFTStereoConfig(n_gru_layers=3, hidden_dims=(32, 32, 32),
                           corr_levels=2, corr_radius=2,
                           compute_dtype="bfloat16", corr_dtype="bfloat16",
                           gru_backend=gru_backend)
    model = RAFTStereo(cfg, device=dev, seed=4)
    fns = {k: getattr(cuda_gru if k == "gru_update" else cuda_alt, k)
           for k in want}
    for f in fns.values():
        f.launches = 0
    rng = np.random.default_rng(22)
    i1, i2 = (torch.from_numpy(rng.uniform(0, 255, (1, 32, 48, 3))
                               .astype(np.float32)).to(dev) for _ in range(2))
    lo, up = model(i1, i2, iters=3)
    torch.cuda.synchronize()
    assert {k: f.launches for k, f in fns.items()} == want
    assert lo.dtype == up.dtype == torch.float32
    assert bool(torch.isfinite(up).all())


# -------------------------------------------- rows 3, 4 (general taps), 8

def _taps_inputs(dev, rng, n, w1, widths, kk, dtype=torch.float32, c=256):
    """Flat feature maps and taps mixing the radial pattern, random reals
    in [-3, w + 3], exact integers, far-outside and infinite taps and one
    NaN tap."""
    f1 = _randn(rng, n, w1, c).to(dev, dtype)
    f2 = _randn(rng, n, sum(widths), c).to(dev, dtype)
    cols = []
    for w in widths:
        t = rng.uniform(-3.0, w + 3.0, (n, w1, kk))
        t[..., 0] = np.floor(t[..., 0])
        t[..., 1:4] = rng.uniform(-2.0, w + 1.0, (n, w1, 1)) + np.arange(-1, 2)
        t[0, :4, -1] = [-1e6, 1e6, np.inf, -np.inf]
        cols.append(t)
    taps = np.concatenate(cols, axis=-1).astype(np.float32)
    taps[n - 1, w1 - 1, 2] = np.nan
    return f1, f2, torch.from_numpy(taps).to(dev)


@pytest.mark.parametrize("n,w1,widths,dtype,out_dtype,c", [
    (11, 20, (20, 10, 5, 2), torch.float32, torch.float32, 256),
    (480, 180, (180, 90, 45, 22), torch.float32, torch.float32, 256),
    (11, 20, (20, 10, 5, 2), torch.bfloat16, torch.float32, 256),
    (11, 20, (20, 10, 5, 2), torch.bfloat16, torch.bfloat16, 256),
    (11, 20, (20, 10, 5, 2), torch.float32, torch.float32, 192),
    (11, 20, (20, 10, 5, 2), torch.float32, torch.float32, 640),
    (11, 20, (20, 10, 5, 2), torch.bfloat16, torch.float32, 200)],
    ids=["hostile", "training", "bf16_in", "bf16_in_out", "c192", "c640",
         "c200_bf16"])
def test_alt_corr_taps_kernel_matches_plain(dev, n, w1, widths, dtype,
                                            out_dtype, c):
    """Row 3: within 1e-5 of max(1, |plain|) in fp32 (dots of length C
    summed in another order), one bf16 ulp with a bf16 output; NaN only
    at the NaN tap, 0 at taps outside.  C that is not a multiple of the
    kernel's 128 (fp32) or 256 (bf16) channels is zero-padded, and C
    above 512 reads its tail through the caches."""
    from raftstereo_tpu_torch.ops import alt_lookup

    rng = np.random.default_rng(40)
    f1, f2, taps = _taps_inputs(dev, rng, n, w1, widths, 9, dtype, c)
    before = alt_lookup.alt_corr_taps.launches
    got = alt_lookup.alt_corr_taps(f1, f2, taps, widths, out_dtype)
    assert alt_lookup.alt_corr_taps.launches == before + 1
    want = alt_lookup.alt_corr_taps_plain(f1, f2, taps, widths, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype
    assert torch.equal(got.isnan(), want.isnan()) and got.isnan().sum() == 1
    assert (got[0, :4, 8::9] == 0).all()
    tol = 1.0 if out_dtype == torch.bfloat16 else 1e-5 * 2 ** 7
    assert _bf16_ulps(got, want) <= tol


@pytest.mark.parametrize("n,w1,widths,c", [
    (11, 20, (20, 10, 5, 2), 256), (480, 180, (180, 90, 45, 22), 256),
    (11, 20, (20, 10, 5, 2), 192), (11, 20, (20, 10, 5, 2), 640),
    (2, 1248, (1248, 624, 312, 156), 256)],
    ids=["hostile", "training", "c192", "c640", "wide"])
def test_alt_corr_taps_backward_kernel_matches_plain(dev, n, w1, widths, c):
    """Row 4 with general taps: bitwise repeatable, within 1e-4 of the
    largest plain gradient, NaN where the dense hat is NaN (the NaN tap's
    pixel and its row's level; an infinite cotangent's columns).  C=192
    is zero-padded, C=640 runs two channel groups, and W1=1248 walks its
    row in three tiles of pixels (its tables exceed shared memory)."""
    from raftstereo_tpu_torch.ops import alt_lookup

    rng = np.random.default_rng(41)
    f1, f2, taps = _taps_inputs(dev, rng, n, w1, widths, 9, c=c)
    g = _randn(rng, *taps.shape).to(dev)
    g[1, 3, 20] = float("inf")
    before = alt_lookup.alt_corr_taps_backward.launches
    k1 = alt_lookup.alt_corr_taps_backward(f1, f2, taps, g, widths)
    k2 = alt_lookup.alt_corr_taps_backward(f1, f2, taps, g, widths)
    assert alt_lookup.alt_corr_taps_backward.launches == before + 2
    want = alt_lookup.alt_corr_taps_backward_plain(f1, f2, taps, g, widths)
    torch.cuda.synchronize()
    for a, b, w in zip(k1, k2, want):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
        assert torch.equal(a.isnan(), w.isnan())
        assert torch.equal(a.isinf(), w.isinf())
        ok = torch.isfinite(w)
        scale = max(1.0, float(w[ok].abs().max()))
        assert float((a[ok] - w[ok]).abs().max()) <= 1e-4 * scale
        assert torch.equal(a[~ok].nan_to_num(7.0), w[~ok].nan_to_num(7.0))


def _edge_taps(taps, widths, kk):
    """Taps at -1, 0, w - 1 and w (the last tap of each level) on the
    last row's pixels 4-7."""
    for lvl, w in enumerate(widths):
        taps[-1, 4:8, lvl * kk + kk - 1] = torch.tensor(
            [-1.0, 0.0, w - 1.0, float(w)])
    return taps


@pytest.mark.parametrize("n,w1,widths,kk,c,dtype,out_dtype", [
    (2, 20, (20, 0, 1, 5), 9, 128, torch.float32, torch.float32),
    (2, 70, (70, 35, 17, 8), 9, 384, torch.float32, torch.float32),
    (2, 70, (70, 35, 17, 8), 9, 256, torch.bfloat16, torch.bfloat16),
    (1, 8, (100, 50), 300, 128, torch.float32, torch.float32),
    (1, 8, (700,), 400, 128, torch.float32, torch.float32)],
    ids=["w0w1", "ragged_c384", "ragged_bf16", "many_taps", "general"])
def test_alt_corr_taps_kernel_hostile_cases(dev, n, w1, widths, kk, c,
                                            dtype, out_dtype):
    """Row 3 on the CPU emulation's hostile cases
    (``tests/test_torch_port_taps_fwd.py``): levels of width 0 and 1, W1
    not a multiple of the 64-pixel tile, C = 384, taps at -1, 0, w - 1
    and w, 300 taps a level (several rounds of slots), and a 700-wide
    level with 400 taps (the general form); within 1e-5 of max(1,
    |plain|) in fp32 and one bf16 ulp with a bf16 output, NaN only at the
    NaN tap, two calls bitwise equal."""
    from raftstereo_tpu_torch.ops import alt_lookup

    rng = np.random.default_rng(44)
    f1, f2, taps = _taps_inputs(dev, rng, n, w1, widths, kk, dtype, c)
    taps = _edge_taps(taps, widths, kk)
    assert alt_lookup.alt_corr_taps_form(w1, widths, kk) == (
        "general" if kk == 400 else "tiled")
    got = alt_lookup.alt_corr_taps(f1, f2, taps, widths, out_dtype)
    again = alt_lookup.alt_corr_taps(f1, f2, taps, widths, out_dtype)
    want = alt_lookup.alt_corr_taps_plain(f1, f2, taps, widths, out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(got.float().nan_to_num(7.0),
                       again.float().nan_to_num(7.0))
    assert torch.equal(got.isnan(), want.isnan()) and got.isnan().sum() == 1
    tol = 1.0 if out_dtype == torch.bfloat16 else 1e-5 * 2 ** 7
    assert _bf16_ulps(got, want) <= tol


@pytest.mark.parametrize("n,w1,widths,kk,c", [
    (2, 20, (20, 0, 1, 5), 9, 128), (2, 70, (70, 35, 17, 8), 9, 384),
    (2, 4, (64, 32), 9500, 128), (6, 180, (64, 32), 9500, 128)],
    ids=["w0w1", "ragged_c384", "taps_near_limit", "near_limit_batches"])
def test_alt_corr_taps_backward_kernel_hostile_cases(dev, n, w1, widths, kk,
                                                     c):
    """Row 4 with general taps on the CPU emulation's hostile cases
    (``tests/test_torch_port_taps_bwd.py``): levels of width 0 and 1, W1
    not a multiple of 32, C = 384, taps at -1, 0, w - 1 and w, NaN, +inf
    and -inf cotangents, and 19,000 taps a pixel in two levels (one
    pixel's tables fill shared memory; 20,000 are refused), also at 6 rows
    of 180 pixels, whose lists (55 MB a row) run in two batches of rows
    sharing the workspace.  Bitwise repeatable, NaN and
    +-inf where plain has them, within 1e-4 of the largest elsewhere."""
    from raftstereo_tpu_torch.ops import alt_lookup

    rng = np.random.default_rng(45)
    f1, f2, taps = _taps_inputs(dev, rng, n, w1, widths, kk, c=c)
    if w1 >= 8:
        taps = _edge_taps(taps, widths, kk)
    g = _randn(rng, *taps.shape).to(dev)
    g[0, 1, 3] = float("inf")
    g[0, 2, kk + 1 if len(widths) > 1 else 5] = float("nan")
    g[-1, -1, 0] = -float("inf")
    k1 = alt_lookup.alt_corr_taps_backward(f1, f2, taps, g, widths)
    k2 = alt_lookup.alt_corr_taps_backward(f1, f2, taps, g, widths)
    want = alt_lookup.alt_corr_taps_backward_plain(f1, f2, taps, g, widths)
    torch.cuda.synchronize()
    for a, b, w in zip(k1, k2, want):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
        assert torch.equal(a.isnan(), w.isnan())
        assert torch.equal(a.isinf(), w.isinf())
        assert torch.equal(a[w.isinf()], w[w.isinf()])
        ok = torch.isfinite(w)
        assert bool(ok.any())
        scale = max(1.0, float(w[ok].abs().max()))
        assert float((a[ok] - w[ok]).abs().max()) <= 1e-4 * scale
    batch = _build.load("alt_corr_taps_bwd").alt_corr_taps_backward_batch
    batch.restype = ctypes.c_long
    batch.argtypes = [ctypes.c_long] + [ctypes.c_int] * 4
    rows_a_batch = batch(n, w1, sum(widths), len(widths), kk)
    assert (rows_a_batch < n) == (w1 == 180)
    if kk == 9500:
        with pytest.raises(NotImplementedError, match="tables must fit"):
            alt_lookup.alt_corr_taps_backward(
                f1, f2, taps[..., :1].repeat(1, 1, 20000).contiguous(),
                g[..., :1].repeat(1, 1, 20000).contiguous(), widths)


@pytest.mark.parametrize("shape,dtype,relu", [
    ((2, 64, 36, 60), torch.float32, False),
    ((2, 64, 36, 60), torch.float32, True),
    ((3, 5, 7, 9), torch.float32, True),
    ((2, 64, 36, 60), torch.bfloat16, False),
    ((2, 64, 36, 60), torch.bfloat16, True),
    ((2, 3, 288, 480), torch.float32, True),
    ((1, 3, 145, 127), torch.bfloat16, False),
    ((1, 2, 1024, 1024), torch.float32, True),
    ((1, 2, 1800, 1024), torch.bfloat16, False)],
    ids=["fp32", "fp32_relu", "odd", "bf16", "bf16_relu", "serve_planes",
         "odd_bf16_two_blocks", "two_kernels", "two_kernels_bf16"])
def test_instance_norm_kernels_match_plain(dev, shape, dtype, relu):
    """Row 8: ``instance_norm_act`` makes one cluster launch where
    ``cluster_plan`` takes the plane (here 1, 2 or 8 blocks a plane), else
    one stats and one apply launch (planes of 4 MB and 3.7 MB); both forms
    are also forced, each where it applies: the output within 1e-5 of
    max(1, |plain|) in fp32 and one bf16 ulp in bf16, bitwise repeatable;
    the stats kernel's statistics within 1e-5 relative (plane sums in
    another order)."""
    from raftstereo_tpu_torch.ops import norm

    rng = np.random.default_rng(42)
    x = (_randn(rng, *shape) * 1.5 + 0.4).to(dev, dtype)
    fits = norm.cluster_plan(shape[2] * shape[3], dtype) is not None
    fns = (norm.in_norm_cluster, norm.in_stats, norm.in_apply)
    before = [f.launches for f in fns]
    y = norm.instance_norm_act(x, relu)
    y2 = norm.instance_norm_act(x, relu)
    assert [f.launches - b for f, b in zip(fns, before)] == (
        [2, 0, 0] if fits else [0, 2, 2])
    want = norm.in_apply_plain(x, *norm.in_stats_plain(x), relu)
    forms = [norm.in_apply(x, *norm.in_stats(x), relu)]
    if fits:
        forms.append(norm.in_norm_cluster(x, relu))
    else:
        with pytest.raises(ValueError, match="beyond"):
            norm.in_norm_cluster(x, relu)
    torch.cuda.synchronize()
    assert y.dtype == dtype and torch.equal(y, y2)
    assert torch.equal(forms[-1], y)
    for got, ref in zip(norm.in_stats(x), norm.in_stats_plain(x)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    tol = 1.0 if dtype == torch.bfloat16 else 1e-5 * 2 ** 7
    for got in forms:
        assert _bf16_ulps(got, want) <= tol


def test_instance_norm_cluster_special_planes(dev):
    """Row 8's cluster form on a constant plane (its variance clamped: 0
    throughout), a NaN plane (NaN throughout), and on a view 4 bytes past
    a 16-byte boundary (the scalar path), each against plain; one cluster
    launch a call."""
    from raftstereo_tpu_torch.ops import norm

    rng = np.random.default_rng(44)
    x = _randn(rng, 2, 3, 160, 130) * 1.7 + 0.6
    x[0, 1] = 2001.0
    x[1, 0, 80, 43] = float("nan")
    x = x.to(dev)
    shifted = x.reshape(-1)[1:1 + 3 * 160 * 129].reshape(1, 3, 160, 129)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    before = norm.in_norm_cluster.launches
    for t in (x, shifted):
        got = norm.instance_norm_act(t, True)
        want = norm.in_apply_plain(t, *norm.in_stats_plain(t), True)
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        scale = want[ok].abs().clamp_min(1.0)
        assert float(((got[ok] - want[ok]).abs() / scale).max()) <= 1e-5
    assert norm.in_norm_cluster.launches == before + 2
    y = norm.instance_norm_act(x, False)
    assert not y[0, 1].any() and torch.isnan(y[1, 0]).all()


def test_lookup_and_norm_ops_on_card_never_run_plain(dev, monkeypatch):
    """The op path's forward and backward on the card with every plain
    version patched to raise: one lookup and one general backward, or one
    cluster launch of the norm, per call; gradients match the CPU's."""
    from raftstereo_tpu_torch.ops import alt_lookup, norm

    rng = np.random.default_rng(43)
    f1, f2, taps = _taps_inputs(torch.device("cpu"), rng, 6, 16, (16, 8),
                                5)
    taps[-1, -1, 2] = 3.25  # finite gradients
    x = _randn(rng, 2, 8, 12, 10) + 0.3
    cot = _randn(rng, 2, 3, 16, 10)

    def grads(device):
        a, b = (t.detach().to(device).clone().requires_grad_(True)
                for t in (f1, f2))
        out = alt_lookup.pallas_alt_pyramid_flat(
            a, b, taps.to(device).reshape(2, 3, 16, 10), (16, 8))
        (out * cot.to(device)).sum().backward()
        xr = x.detach().to(device).clone().requires_grad_(True)
        y = norm.instance_norm_act(xr, True)
        (y * y).sum().backward()
        return [t.cpu() for t in (out, a.grad, b.grad, y, xr.grad)]

    want = grads("cpu")

    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card path")

    for name in ("alt_corr_taps_plain", "alt_corr_taps_backward_plain"):
        monkeypatch.setattr(alt_lookup, name, boom)
    for name in ("in_stats_plain", "in_apply_plain"):
        monkeypatch.setattr(norm, name, boom)
    fns = (alt_lookup.alt_corr_taps, alt_lookup.alt_corr_taps_backward,
           norm.in_norm_cluster, norm.in_stats, norm.in_apply)
    for f in fns:
        f.launches = 0
    got = grads(dev)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [1, 1, 1, 0, 0]
    for a, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((a - w).abs().max()) <= 1e-4 * scale
    with pytest.raises(ValueError):  # taps on the CPU, features on the card
        alt_lookup.alt_corr_taps(f1.to(dev), f2.to(dev), taps, (16, 8))
    with pytest.raises(NotImplementedError):  # more levels than 8
        alt_lookup.alt_corr_taps(f1.to(dev), f2[:, :9].contiguous().to(dev),
                                 taps[..., :9].contiguous().to(dev),
                                 (1,) * 9)
    with pytest.raises(ValueError):  # an fp16 cotangent
        alt_lookup.alt_corr_taps_backward(f1.to(dev), f2.to(dev),
                                          taps.to(dev),
                                          taps.to(dev, torch.float16),
                                          (16, 8))
    with pytest.raises(ValueError):  # a non-contiguous tensor
        norm.in_stats(x.to(dev).transpose(2, 3))
    with pytest.raises(ValueError):  # a non-contiguous tensor
        norm.in_norm_cluster(x.to(dev).transpose(2, 3))
    with pytest.raises(ValueError):  # float64
        norm.in_norm_cluster(x.to(dev).double())
    with pytest.raises(ValueError, match="beyond"):  # a 4 MB plane
        norm.in_norm_cluster(torch.zeros((1, 1, 1024, 1024), device=dev))


# ------------------------------------------------- bf16 training, row 4

def _bf16_bwd_check(k1, k2, want):
    """Row 4's bf16 forms against their bf16 plain versions: bf16
    gradients, two calls bitwise equal, NaN and +-inf where plain has
    them, within one bf16 ulp of max(1, |plain|) and at least 99% of the
    finite elements equal (fp32 sums in another order)."""
    for a, b, w in zip(k1, k2, want):
        assert a.dtype == w.dtype == torch.bfloat16
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
        assert torch.equal(a.isnan(), w.isnan())
        assert torch.equal(a.isinf(), w.isinf())
        ok = torch.isfinite(w)
        assert _bf16_ulps(a[ok], w[ok]) <= 1.0
        assert float((a[ok] == w[ok]).float().mean()) >= 0.99


@pytest.mark.parametrize("shape,levels,radius", [
    ((2, 11, 20), 4, 4), ((6, 80, 180), 4, 4), ((1, 2, 4), 4, 2)],
    ids=["hostile", "training", "zero_width_level"])
def test_alt_corr_backward_bf16_kernel_matches_plain(dev, shape, levels,
                                                     radius):
    """Row 4 radial's bf16 form (bf16 maps, a bf16 cotangent, bf16
    gradients) at a hostile shape (taps past both edges, a NaN coordinate,
    an infinite cotangent), the training path's shape and a width-0 top
    level."""
    rng = np.random.default_rng(50)
    st, x, g = _bwd_inputs(dev, rng, *shape, levels, radius,
                           nan=shape[2] > 4)
    st = build_corr_state(st.fmap1, st.f2cat[:, :, :shape[2]], levels,
                          corr_dtype=torch.bfloat16)
    g = g.to(torch.bfloat16)
    if shape[2] > 4:
        g[0, 1, 5, 3] = float("inf")
    before = cuda_alt.alt_corr_backward.launches
    k1, k2 = (cuda_alt.alt_corr_backward(st.fmap1, st.f2cat, st.widths, x,
                                         g, radius) for _ in range(2))
    assert cuda_alt.alt_corr_backward.launches == before + 2
    want = cuda_alt.alt_corr_backward_plain(st.fmap1, st.f2cat, st.widths, x,
                                            g, radius)
    torch.cuda.synchronize()
    _bf16_bwd_check(k1, k2, want)


def test_alt_corr_backward_bf16_cotangent_of_fp32_maps(dev):
    """fp32 maps with a bf16 cotangent (``corr_dtype="float32"`` in a bf16
    model): the cotangent is widened to fp32, exactly, and the fp32 form
    runs: bitwise equal to it on the widened cotangent."""
    rng = np.random.default_rng(51)
    st, x, g = _bwd_inputs(dev, rng, 6, 80, 180, 4, 4, nan=True)
    gb = g.to(torch.bfloat16)
    got = cuda_alt.alt_corr_backward(st.fmap1, st.f2cat, st.widths, x, gb, 4)
    want = cuda_alt.alt_corr_backward(st.fmap1, st.f2cat, st.widths, x,
                                      gb.float(), 4)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.dtype == torch.float32
        assert torch.equal(a.nan_to_num(7.0), w.nan_to_num(7.0))


@pytest.mark.parametrize("n,w1,widths,c,repeat", [
    (11, 20, (20, 10, 5, 2), 256, False), (11, 20, (20, 10, 5, 2), 256, True),
    (480, 180, (180, 90, 45, 22), 256, False),
    (11, 20, (20, 10, 5, 2), 200, True)],
    ids=["hostile", "repeat", "training", "c200"])
def test_alt_corr_taps_backward_bf16_kernel_matches_plain(dev, n, w1, widths,
                                                          c, repeat):
    """Row 4 general's bf16 form: bf16 maps and cotangent, bf16 gradients.
    ``repeat``: taps 4-6 of each level repeat taps 1-3 (non-consecutive
    taps on the same columns), so a pixel's coefficient on a column is a
    sum over taps that must be complete before it is rounded.  C=200 is
    zero-padded to the kernel's 256."""
    from raftstereo_tpu_torch.ops import alt_lookup

    rng = np.random.default_rng(52)
    f1, f2, taps = _taps_inputs(dev, rng, n, w1, widths, 9, torch.bfloat16,
                                c)
    if repeat:
        for lvl in range(len(widths)):
            taps[..., lvl * 9 + 4:lvl * 9 + 7] = taps[..., lvl * 9 + 1:
                                                      lvl * 9 + 4]
    g = _randn(rng, *taps.shape).to(dev, torch.bfloat16)
    g[1, 3, 20] = float("inf")
    before = alt_lookup.alt_corr_taps_backward.launches
    k1, k2 = (alt_lookup.alt_corr_taps_backward(f1, f2, taps, g, widths)
              for _ in range(2))
    assert alt_lookup.alt_corr_taps_backward.launches == before + 2
    want = alt_lookup.alt_corr_taps_backward_plain(f1, f2, taps, g, widths)
    torch.cuda.synchronize()
    _bf16_bwd_check(k1, k2, want)


@pytest.mark.parametrize("corr_dtype", ["bfloat16", "float32"])
def test_bf16_training_on_card_never_runs_plain(dev, corr_dtype,
                                                monkeypatch):
    """A bf16 train-mode step on the card with the lookup's and its
    backward's plain versions patched to raise: one lookup and one
    backward kernel per iteration, finite bf16 predictions' loss and fp32
    gradients."""
    from raftstereo_tpu_torch.train.loss import sequence_loss

    cfg = RAFTStereoConfig(n_gru_layers=3, hidden_dims=(32, 32, 32),
                           corr_levels=2, corr_radius=2,
                           compute_dtype="bfloat16", corr_dtype=corr_dtype)
    m = RAFTStereo(cfg, device=dev, seed=4)
    rng = np.random.default_rng(53)
    imgs = [torch.from_numpy(rng.uniform(0, 255, (1, 32, 48, 3))
                             .astype(np.float32)).to(dev) for _ in range(2)]

    def boom(*a, **k):
        raise AssertionError("a plain version ran on the card path")

    for name in ("alt_corr_plain", "alt_corr_backward_plain"):
        monkeypatch.setattr(cuda_alt, name, boom)
    fns = (cuda_alt.alt_corr, cuda_alt.alt_corr_backward,
           cuda_alt.alt_corr_epi)
    for f in fns:
        f.launches = 0
    preds = m(*imgs, iters=3, test_mode=False)
    loss, _ = sequence_loss(preds, -10 * torch.ones((1, 32, 48, 1),
                                                    device=dev),
                            torch.ones((1, 32, 48), device=dev))
    loss.backward()
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [3, 3, 0]
    assert torch.isfinite(loss)
    for k, p in m.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, k
        assert bool(torch.isfinite(p.grad).all()), k
