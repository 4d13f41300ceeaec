"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: they skip without a GPU.  The machine with the
card has no JAX, so this file imports none and is run without the
repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig
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


@pytest.mark.parametrize("batch", [1, 3])
def test_fused_encoder_on_card_never_runs_plain(dev, batch, monkeypatch):
    """``fused_encoder=True`` on CUDA tensors: every plain version patched
    to raise, the model runs, launches counted per row (batch 3: fnet's 6
    images take plain conv1 + the stats kernel), and the result matches
    the CPU forward (plain versions) within the parity thresholds."""
    cfg = RAFTStereoConfig(n_gru_layers=3, hidden_dims=(32, 32, 32),
                           corr_levels=2, corr_radius=2, fused_encoder=True)
    gpu = RAFTStereo(cfg, device=dev, seed=4)
    cpu = RAFTStereo(cfg, device="cpu", seed=4)
    rng = np.random.default_rng(batch)
    imgs = [torch.from_numpy(rng.uniform(0, 255, (batch, 32, 48, 3))
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
    assert got == {"stem_conv7": 2 - big, "stem_conv7_s2": 0,
                   "stage_conv": 8, "plane_stats": int(big),
                   "stage_finish": 2, "l2_entry": 2, "l2_conv": 6,
                   "l2_finish": 2, "dual_sums": 0}
    torch.testing.assert_close(lo_g.cpu(), lo_c, rtol=0, atol=2e-3)
    torch.testing.assert_close(up_g.cpu(), up_c, rtol=0, atol=5e-3)


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
    assert cuda_vol.vol_lookup.launches == before + 1
    want = cuda_vol.vol_lookup_plain(st.vcat, st.widths, x, radius)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    if shape[2] > 4:
        assert torch.isnan(got[-1, -1, -1]).all()


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
    assert quant.int8_corr_volume.launches == before + 1
    want = quant.int8_volume_plain(q1, s1, q2, s2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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


@pytest.mark.parametrize("shape,dtype,relu", [
    ((2, 64, 36, 60), torch.float32, False),
    ((2, 64, 36, 60), torch.float32, True),
    ((3, 5, 7, 9), torch.float32, True),
    ((2, 64, 36, 60), torch.bfloat16, False),
    ((2, 64, 36, 60), torch.bfloat16, True)],
    ids=["fp32", "fp32_relu", "odd", "bf16", "bf16_relu"])
def test_instance_norm_kernels_match_plain(dev, shape, dtype, relu):
    """Row 8: stats within 1e-5 relative (plane sums in another order),
    the output within 1e-5 of max(1, |plain|) in fp32 and one bf16 ulp in
    bf16; one launch of each kernel, both bitwise repeatable."""
    from raftstereo_tpu_torch.ops import norm

    rng = np.random.default_rng(42)
    x = (_randn(rng, *shape) * 1.5 + 0.4).to(dev, dtype)
    s0, a0 = norm.in_stats.launches, norm.in_apply.launches
    y = norm.instance_norm_act(x, relu)
    y2 = norm.instance_norm_act(x, relu)
    assert (norm.in_stats.launches, norm.in_apply.launches) == (s0 + 2,
                                                                a0 + 2)
    want = norm.in_apply_plain(x, *norm.in_stats_plain(x), relu)
    torch.cuda.synchronize()
    assert y.dtype == dtype and torch.equal(y, y2)
    for got, ref in zip(norm.in_stats(x), norm.in_stats_plain(x)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    tol = 1.0 if dtype == torch.bfloat16 else 1e-5 * 2 ** 7
    assert _bf16_ulps(y, want) <= tol


def test_lookup_and_norm_ops_on_card_never_run_plain(dev, monkeypatch):
    """The op path's forward and backward on the card with every plain
    version patched to raise: one lookup and one general backward, or one
    stats and one apply launch, per call; gradients match the CPU's."""
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
           norm.in_stats, norm.in_apply)
    for f in fns:
        f.launches = 0
    got = grads(dev)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [1, 1, 1, 1]
    for a, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        assert float((a - w).abs().max()) <= 1e-4 * scale
    with pytest.raises(ValueError):  # taps on the CPU, features on the card
        alt_lookup.alt_corr_taps(f1.to(dev), f2.to(dev), taps, (16, 8))
    with pytest.raises(NotImplementedError):  # more levels than 8
        alt_lookup.alt_corr_taps(f1.to(dev), f2[:, :9].contiguous().to(dev),
                                 taps[..., :9].contiguous().to(dev),
                                 (1,) * 9)
    with pytest.raises(ValueError):  # a bf16 cotangent
        alt_lookup.alt_corr_taps_backward(f1.to(dev), f2.to(dev),
                                          taps.to(dev),
                                          taps.to(dev, torch.bfloat16),
                                          (16, 8))
    with pytest.raises(ValueError):  # a non-contiguous tensor
        norm.in_stats(x.to(dev).transpose(2, 3))
