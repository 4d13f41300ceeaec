"""The port's ops and kernel plain versions against the JAX package, CPU.

Inputs are made with numpy from a seed and passed to both packages.  The
JAX side runs its Pallas kernels in interpret mode (automatic off the
TPU) and its XLA references; the port runs its plain PyTorch versions
(the wrappers take them for CPU tensors).  Tolerances are stated per
test with their reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raftstereo_tpu.ops import corr as jcorr
from raftstereo_tpu.ops import image as jimage
from raftstereo_tpu.ops import pallas_gru as jgru
from raftstereo_tpu.ops import upsample as jup
from raftstereo_tpu_torch import RAFTStereoConfig
from raftstereo_tpu_torch.models.update import BasicMultiUpdateBlock
from raftstereo_tpu_torch.ops import (_build, cuda_alt, cuda_gru, image,
                                     upsample)
from raftstereo_tpu_torch.ops.corr import (build_corr_state,
                                           build_fmap2_pyramid, corr_lookup)
from raftstereo_tpu_torch.utils.convert import variables_to_state_dict

# fp32 sums taken in another order than XLA's (matmul vs gather-then-dot,
# concatenated vs sliced conv operands): a few ulps of O(1) values.
FP32_TOL = dict(rtol=1e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


# ------------------------------------------------------------ image ops

@pytest.mark.parametrize("hw,out", [((5, 7), (9, 13)), ((6, 4), (11, 8)),
                                    ((1, 5), (3, 9))])
def test_resize_bilinear_align_corners_matches_jax(hw, out):
    x = np.random.default_rng(0).normal(size=(2,) + hw + (3,)).astype(
        np.float32)
    want = np.asarray(jimage.resize_bilinear_align_corners(jnp.asarray(x),
                                                           out))
    got = image.resize_bilinear_align_corners(_t(x), out).numpy()
    np.testing.assert_allclose(got, want, **FP32_TOL)


@pytest.mark.parametrize("hw", [(8, 12), (7, 9)])
def test_avg_pool2x_matches_jax(hw):
    x = np.random.default_rng(1).normal(size=(2,) + hw + (4,)).astype(
        np.float32)
    want = np.asarray(jimage.avg_pool2x(jnp.asarray(x)))
    got = image.avg_pool2x(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, **FP32_TOL)


@pytest.mark.parametrize("hw,divis,bucket,mode", [
    ((540, 960), 32, 64, "sintel"), ((37, 51), 8, None, "sintel"),
    ((37, 51), 32, 64, "kitti"), ((64, 96), 32, 64, "sintel")])
def test_bucket_padder_matches_jax(hw, divis, bucket, mode):
    x = np.random.default_rng(2).uniform(0, 255, (1,) + hw + (3,)).astype(
        np.float32)
    jp = jimage.BucketPadder(x.shape, divis_by=divis,
                             bucket_multiple=bucket, mode=mode)
    tp = image.BucketPadder(x.shape, divis_by=divis, bucket_multiple=bucket,
                            mode=mode)
    assert tp.bucket_hw == jp.bucket_hw
    want = np.asarray(jp.pad(jnp.asarray(x)))
    got = tp.pad(_t(x))
    np.testing.assert_array_equal(got.numpy(), want)  # pure copies
    np.testing.assert_array_equal(tp.unpad(got).numpy(), x)


def test_coords_grid_x_matches_jax():
    np.testing.assert_array_equal(image.coords_grid_x(2, 3, 5).numpy(),
                                  np.asarray(jimage.coords_grid_x(2, 3, 5)))


@pytest.mark.parametrize("factor", [4, 8])
def test_convex_upsample_matches_jax(factor):
    rng = np.random.default_rng(3)
    flow = rng.normal(size=(2, 5, 6, 1)).astype(np.float32) * 10
    mask = rng.normal(size=(2, 5, 6, 9 * factor * factor)).astype(np.float32)
    want = np.asarray(jup.convex_upsample(jnp.asarray(flow),
                                          jnp.asarray(mask), factor))
    got = upsample.convex_upsample(_t(flow), _t(mask), factor).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)  # x factor


@pytest.mark.parametrize("w", [20, 21])
def test_fmap2_pyramid_matches_jax(w):
    f2 = np.random.default_rng(4).normal(size=(2, 3, w, 8)).astype(
        np.float32)
    want = jcorr.build_fmap2_pyramid(jnp.asarray(f2), 4)
    got = build_fmap2_pyramid(_t(f2), 4)
    assert [g.shape[2] for g in got] == [v.shape[2] for v in want]
    for g, v in zip(got, want):  # means of two: the same exact arithmetic
        np.testing.assert_array_equal(g.numpy(), np.asarray(v))


# -------------------------------------------------------------- lookup

def _features(rng, b, h, w, c=256):
    return (rng.normal(size=(b, h, w, c)).astype(np.float32),
            rng.normal(size=(b, h, w, c)).astype(np.float32),
            (np.arange(w, dtype=np.float32)
             + rng.uniform(-14, 10, (b, h, w)).astype(np.float32)))


def _lookup_inputs(b=2, h=11, w=20):
    """Hostile shapes: odd H, 4 levels down to width 2 (20/10/5/2), taps
    past both edges, and NaN coordinates."""
    f1, f2, x = _features(np.random.default_rng(5), b, h, w)
    x[0, 0, :3] = [-200.5, w + 200.25, 1e6]
    x[0, 1, :2] = [-3.5, w + 1.75]   # partly past each edge
    x[1, 3, 4] = np.nan
    x[0, 5, 7] = np.nan
    return f1, f2, x


@pytest.mark.parametrize("backend", ["pallas_alt", "alt"])
def test_lookup_plain_matches_jax(backend):
    f1, f2, x = _lookup_inputs()
    fn = jcorr.make_corr_fn(backend, jnp.asarray(f1), jnp.asarray(f2), 4, 4)
    want = np.asarray(fn(jnp.asarray(x)[..., None]))
    got = corr_lookup(build_corr_state(_t(f1), _t(f2), 4), _t(x), 4).numpy()
    assert got.shape == want.shape == x.shape + (36,)
    nan_pix = np.isnan(x)
    assert np.isnan(got[nan_pix]).all() and np.isnan(want[nan_pix]).all()
    assert np.isfinite(got[~nan_pix]).all()
    # |corr| ~ 1 (dots of 256 unit normals / 16); fp32 reassociation only.
    np.testing.assert_allclose(got, want, **FP32_TOL)
    # taps past both edges really occurred (zeros beside nonzeros)
    assert (got[0, 0, 0] == 0).all() and (got[0, 0, 2] == 0).all()


def test_lookup_zero_width_level_is_zero():
    """W=4 with 4 levels gives a width-0 top level: finite zeros there."""
    f1, f2, x = _features(np.random.default_rng(6), 1, 2, 4)
    got = corr_lookup(build_corr_state(_t(f1), _t(f2), 4), _t(x), 2).numpy()
    assert got.shape == (1, 2, 4, 20)
    assert (got[..., 15:] == 0).all() and np.isfinite(got).all()


def _vjp_jax(backend, f1, f2, x, g, levels, radius):
    fn = jax.vjp(lambda a, b: jcorr.make_corr_fn(backend, a, b, levels,
                                                 radius)(jnp.asarray(x)[..., None]),
                 jnp.asarray(f1), jnp.asarray(f2))[1]
    return [np.asarray(t) for t in fn(jnp.asarray(g))]


def _vjp_port(f1, f2, x, g, levels, radius):
    """Gradients of the port's differentiable lookup w.r.t. fmap1 and
    fmap2: the backward's plain version, then autograd through the
    pyramid's pooling and concat."""
    t1, t2 = _t(f1).requires_grad_(), _t(f2).requires_grad_()
    out = corr_lookup(build_corr_state(t1, t2, levels), _t(x), radius)
    out.backward(_t(g))
    return [t1.grad.numpy(), t2.grad.numpy()]


@pytest.mark.parametrize("backend,shape,levels,radius,nan", [
    ("pallas_alt", (2, 11, 20), 4, 4, True),
    ("pallas_alt", (1, 2, 4), 4, 2, True),
    ("alt", (2, 11, 20), 4, 4, False),
    ("alt", (1, 2, 4), 4, 2, False)],
    ids=["custom_vjp-hostile", "custom_vjp-zero_width_level",
         "alt_vjp-hostile", "alt_vjp-zero_width_level"])
def test_lookup_backward_plain_matches_jax(backend, shape, levels, radius,
                                           nan):
    """Row 4: the backward's plain version (reached through the autograd
    Function) against the JAX ``custom_vjp`` of the Pallas lookup
    (interpret mode) and against ``jax.vjp`` of the ``alt`` backend, the
    same function.  Taps past both edges; with 4 levels at W=4 the top
    level has width 0.  NaN coordinates: the Pallas VJP poisons the whole
    level row, which the port reproduces; ``alt``'s gather VJP poisons
    only the gathered columns, so that case runs without NaN."""
    b, h, w = shape
    f1, f2, x = _features(np.random.default_rng(8), b, h, w)
    x[0, 0, :3] = [-200.5, w + 200.25, 1e6]
    x[0, 1, :2] = [-3.5, w + 1.75]
    if nan:
        x[-1, -1, -1] = np.nan
    g = np.random.default_rng(9).normal(
        size=(b, h, w, levels * (2 * radius + 1))).astype(np.float32)
    want = _vjp_jax(backend, f1, f2, x, g, levels, radius)
    got = _vjp_port(f1, f2, x, g, levels, radius)
    for gt, wt in zip(got, want):
        assert gt.shape == wt.shape
        np.testing.assert_array_equal(np.isnan(gt), np.isnan(wt))
        assert np.isnan(gt).any() == nan
        # sums of ~40 products of O(1) terms, reordered: ~1e-7.
        np.testing.assert_allclose(np.nan_to_num(gt), np.nan_to_num(wt),
                                   rtol=0, atol=1e-5)


def test_lookup_backward_wrapper_validates_before_launch():
    f1, f2, x = _features(np.random.default_rng(7), 1, 2, 8)
    st = build_corr_state(_t(f1), _t(f2), 2)
    g = torch.zeros((1, 2, 8, 10))
    with pytest.raises(ValueError):
        cuda_alt.alt_corr_backward(st.fmap1.to("meta"), st.f2cat, st.widths,
                                   _t(x), g, 2)


def test_lookup_wrapper_validates_before_launch():
    f1, f2, x = _features(np.random.default_rng(7), 1, 2, 8)
    st = build_corr_state(_t(f1), _t(f2), 2)
    meta = torch.empty_like(st.fmap1, device="meta")
    with pytest.raises(ValueError):
        cuda_alt.alt_corr(meta, st.f2cat, st.widths, _t(x), 2)


# --------------------------------------------------------------- build

def test_kernel_sources_carry_their_notes():
    """Every CUDA source names each TPU kernel it replaces and its bound
    on the card."""
    srcs = _build.sources()
    replaced = {"alt_corr": ("_alt_pyr_radial_kernel",),
                "alt_corr_epi": ("_alt_pyr_radial_epi_kernel",),
                "alt_corr_bwd": ("_alt_pyr_bwd_kernel",),
                "gru_update": ("_gru_update_kernel",),
                "enc_conv": ("_stem7_kernel", "_stem7s2_kernel"),
                "enc_conv_tc": ("_enc_conv_kernel", "_enc_conv_res_kernel",
                                "_l2_entry_kernel", "_l2_conv_kernel",
                                "_l2_conv_res_kernel"),
                "enc_conv_wg": ("_l2_entry_kernel", "_l2_conv_kernel",
                                "_l2_conv_res_kernel"),
                "enc_stats": ("_in_stats_kernel", "_packed_stats",
                              "_dual_sum_kernel"),
                "enc_finish": ("_enc_finish_kernel", "_l2_finish_kernel"),
                "corr_vol": ("_lookup_kernel",),
                "corr_vol_bwd": ("_lookup_bwd_kernel",),
                "int8_volume": ("_int8_volume_kernel",),
                "alt_corr_taps": ("_alt_pyr_fwd_kernel",),
                "alt_corr_taps_bwd": ("_alt_pyr_bwd_kernel", "_make_alt_pyr"),
                "inorm": ("_in_stats_kernel", "_in_apply_kernel")}
    assert set(srcs) == set(replaced)
    for name, path in srcs.items():
        text = path.read_text()
        assert "Bound on an H100" in text
        assert all(k in text for k in replaced[name]), name


def test_library_name_follows_source_content(tmp_path, monkeypatch):
    """An edited source gets a new library name, so it rebuilds."""
    monkeypatch.setattr(_build, "BUILD", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// one")
    first = _build._target(src)
    src.write_text("// two")
    assert _build._target(src) != first
    assert first.parent == tmp_path and first.name.startswith("libk_")


def test_library_name_follows_header_content(tmp_path, monkeypatch):
    """An edited header (``csrc/*.cuh``) gives every source a new library
    name, so the sources that include it rebuild; ``source_text`` appends
    the headers a source includes."""
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text('// k\n#include "t.cuh"\n')
    hdr = tmp_path / "t.cuh"
    hdr.write_text("// one")
    first = _build._target(src)
    hdr.write_text("// two")
    assert _build._target(src) != first
    assert _build.headers() == [hdr]
    assert _build.source_text("k").endswith("// two")


def test_build_without_toolkit_raises(tmp_path, monkeypatch):
    if _build.shutil.which("nvcc") or _build.Path(
            "/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is present")
    monkeypatch.setattr(_build, "BUILD", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


# -------------------------------------------------------------- update

def _update_params(rng, hd, ext, cor):
    """Random update-block parameters in the JAX package's layout."""
    def convp(k, cin, cout):
        return {"kernel": (rng.normal(size=(k, k, cin, cout))
                           / np.sqrt(k * k * cin)).astype(np.float32),
                "bias": rng.normal(scale=0.1, size=cout).astype(np.float32)}
    return {
        "encoder": {"convc1": convp(1, cor, 64), "convc2": convp(3, 64, 64),
                    "convf1": convp(7, 2, 64), "convf2": convp(3, 64, 64),
                    "conv": convp(3, 128, 126)},
        "gru0": {"convzr": convp(3, hd + 128 + ext, 2 * hd),
                 "convq": convp(3, hd + 128 + ext, hd)},
        "flow_head": {"conv1": convp(3, hd, 256), "conv2": convp(3, 256, 2)},
    }


@pytest.fixture(scope="module", params=[1, 3], ids=["no_ext", "ext"])
def update_case(request):
    n = request.param
    hd, cor = 32, 36
    ext = hd if n > 1 else 0
    rng = np.random.default_rng(10 + n)
    params = _update_params(rng, hd, ext, cor)
    cfg = RAFTStereoConfig(n_gru_layers=n, hidden_dims=(hd,) * n,
                           corr_levels=4, corr_radius=4)
    blk = BasicMultiUpdateBlock(cfg)
    sd = {k[len("update_block."):]: v for k, v in variables_to_state_dict(
        {"params": {"update": params}}).items()}
    missing, unexpected = blk.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all(k.split(".")[0] in ("gru16", "gru32", "mask")
               for k in missing), missing
    b, h, w = 2, 9, 13
    acts = dict(
        h=np.tanh(rng.normal(size=(b, h, w, hd))),
        ext=np.tanh(rng.normal(size=(b, h, w, ext))) if ext else None,
        corr=rng.normal(size=(b, h, w, cor)),
        disp=rng.uniform(-8, 2, (b, h, w, 1)),
        cz=rng.normal(size=(b, h, w, hd)), cr=rng.normal(size=(b, h, w, hd)),
        cq=rng.normal(size=(b, h, w, hd)))
    acts = {k: None if v is None else v.astype(np.float32)
            for k, v in acts.items()}
    got = cuda_gru.gru_update(*(None if v is None else _t(v)
                                for v in acts.values()),
                              cuda_gru.pack_update_params(blk, ext))
    return params, acts, ext, [g.numpy() for g in got]


def test_update_plain_matches_xla_reference(update_case):
    params, acts, ext, (hn, delta) = update_case
    wpack = jgru.pack_update_params(params, 36, ext, jnp.float32)
    j = {k: None if v is None else jnp.asarray(v) for k, v in acts.items()}
    want = jgru._xla_reference_update(*j.values(), wpack)
    # fp32 convs over ~3500-term sums, reordered: ~1e-6 of O(1) outputs.
    np.testing.assert_allclose(hn, np.asarray(want[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(delta, np.asarray(want[1]), rtol=1e-4,
                               atol=1e-4)


def test_update_plain_matches_pallas_kernel(update_case):
    """Against the Pallas megakernel itself (interpret mode), fed the
    64-channel zero-padded correlation the model's pallas_alt lookup
    emits, with convc1 packed at that width."""
    params, acts, ext, (hn, delta) = update_case
    wpack = jgru.pack_update_params(params, 64, ext, jnp.float32)
    j = {k: None if v is None else jnp.asarray(v) for k, v in acts.items()}
    j["corr"] = jnp.pad(j["corr"], ((0, 0),) * 3 + ((0, 28),))
    want = jgru.fused_update(*j.values(), wpack)
    np.testing.assert_allclose(hn, np.asarray(want[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(delta, np.asarray(want[1]), rtol=1e-4,
                               atol=1e-4)


def test_update_wrapper_validates_before_launch(update_case):
    _, acts, ext, _ = update_case
    args = [None if v is None else _t(v) for v in acts.values()]
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError):
        cuda_gru.gru_update(*args, {})
