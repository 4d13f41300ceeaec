"""The fused encoder in bf16 (``fused_encoder=True`` with
``compute_dtype="bfloat16"``, the JAX package's fast and turbo tiers on a
fused base) against the JAX package on the CPU.

The JAX side runs its fused stages and kernels at ``dt=bfloat16`` in
interpret mode, as its own tests run them off the TPU; the port runs its
kernels' bf16 plain versions (CPU tensors).  Inputs are made with numpy
from a seed.  Tolerances are in bf16 ulps: one ulp of a value v is
2^-7 * max(1, |v|) (bf16 keeps 8 significant bits).

Both sides round where the JAX kernels round: the prep (the fp32 affine
cast to bf16, one rounding after each product and each sum), a
convolution's exact bf16 products summed in fp32 with the bf16 bias
added in fp32, its output sums taken of that fp32 result, which is then
rounded to bf16 once.  The convolutions' fp32 sums are taken in another
order (oneDNN's against XLA's packed dots), so a few outputs land on the
other side of a bf16 rounding boundary: one kernel's output is held
within 1 ulp with at least 99% of the elements equal.  Through a stage a
flip spreads (a 3x3 conv to its neighbours, an instance norm's mean to
its channel), so stages and encoders are held to measured bounds stated
beside each test.  The kernels' own arithmetic (the bf16 fragment pack,
the stem's K padding, per-op rounding) is emulated in part (e).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_port_encoder import (TINY, _affines, _conv, _convs,
                                     _layer2_params, _port_encoder)
from test_torch_port_encoder_train import _seeded_variables
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse

from raftstereo_tpu import RAFTStereoConfig as JaxConfig
from raftstereo_tpu.models import RAFTStereo as JaxModel
from raftstereo_tpu.models import encoders as jenc
from raftstereo_tpu.ops import pallas_encoder as pe
from raftstereo_tpu.ops import pallas_layer2 as pl2
from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig
from raftstereo_tpu_torch.models import encoders as tenc
from raftstereo_tpu_torch.ops import _build
from raftstereo_tpu_torch.ops import cuda_encoder as ce
from raftstereo_tpu_torch.ops import encoder_stage as es
from raftstereo_tpu_torch.utils.convert import variables_to_state_dict

BF = torch.bfloat16
JBF = jnp.bfloat16
ULP = 2.0 ** -7
B, H, W, C = 2, 16, 24, 8
CO = 12  # layer2's width at these sizes
# One kernel against its JAX kernel: the fp32 sums of the same exact
# products in another order round to the other bf16 neighbour at a
# boundary; the output sums are fp32 sums of 384 (or 96) values.
KERNEL_ULPS, KERNEL_EQUAL = 1.0, 0.99
SUMS_TOL = 1e-5  # relative to max(1, |want|), per pixel (divided by H*W)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulps(got, want) -> np.ndarray:
    got, want = _np(got), _np(want)
    return np.abs(got - want) / np.maximum(1.0, np.abs(want)) / ULP


def _equal(got, want) -> float:
    return float(np.mean(_np(got) == _np(want)))


def _t(a) -> torch.Tensor:
    """NHWC (JAX) -> NCHW torch in bf16 (of bf16-valued data)."""
    return torch.from_numpy(np.ascontiguousarray(
        _np(a).transpose(0, 3, 1, 2))).to(BF)


def _nhwc(t) -> np.ndarray:
    return _np(t).transpose(0, 2, 3, 1)


def _bf(rng, shape, scale=1.0, shift=0.0):
    """A seeded bf16 JAX array (NHWC)."""
    return jnp.asarray((rng.normal(size=shape) * scale + shift)
                       .astype(np.float32)).astype(JBF)


def _aff(rng, b, c, positive_shift=True):
    """An fp32 prep affine, per image: the port's (B, C) pair and the JAX
    kernels' packed (B, 1, 2C) and flat (B, 1, C) forms."""
    s = (0.5 + rng.random((b, c))).astype(np.float32)
    t = ((0.5 if positive_shift else 1.0) * rng.random((b, c))
         - (0.0 if positive_shift else 0.5)).astype(np.float32)
    port = (torch.from_numpy(s), torch.from_numpy(t))
    flat = (jnp.asarray(s)[:, None], jnp.asarray(t)[:, None])
    packed = tuple(pe.pack_vec(a) for a in flat)
    return port, packed, flat


def _check_out(got, want, ulps=KERNEL_ULPS, equal=KERNEL_EQUAL,
               scale=0.5):
    assert got.dtype == BF
    g = _nhwc(got)
    assert g.shape == want.shape
    if scale:
        assert np.abs(_np(want)).max() > scale  # a non-trivial comparison
    assert _ulps(g, want).max() <= ulps
    assert _equal(g, want) >= equal


def _check_sums(got, want, n):
    for g, w in zip(got, want):
        w = _np(w)
        assert g.dtype == torch.float32
        err = np.abs(_np(g) - w).max() / n
        assert err <= SUMS_TOL * max(1.0, np.abs(w).max() / n)


def _unpack_sums(sums, c):
    """Packed (B, 1, 2C) sums -> (B, C): the two pixel parities."""
    return [s[:, 0, :c] + s[:, 0, c:] for s in sums]


# ------------------------------------------ (a) plain versions vs kernels

@pytest.mark.parametrize("form", ["prep", "res"])
def test_stage_conv_bf16_plain_matches_jax_kernel(form):
    """Row 9 (``_enc_conv_kernel`` / ``_enc_conv_res_kernel``) on the
    packed view ``_stage_on_packed`` builds, against ``conv_plain`` in
    bf16: prep, or the residual block boundary relu(prep(r) + prep(x));
    shifts > 0, so a pad before the prep would show at the border."""
    rng = np.random.default_rng(1)
    x = _bf(rng, (B, H, W, C), 2.0, 0.3)
    r = _bf(rng, (B, H, W, C), 2.0, -0.4)
    (ta, pa, _), (tr, pr, _) = _aff(rng, B, C), _aff(rng, B, C)
    jp, (wt, bt) = _conv(rng, 3, C, C)
    w9 = pe.pack_weights(jp["kernel"]).astype(JBF)
    bias = pe.pack_vec(jp["bias"]).astype(JBF)
    res = form == "res"
    y, sums = pe._enc_conv(pe.pack_view(x), pa, w9, bias,
                           res=pe.pack_view(r) if res else None,
                           res_stats=pr if res else None)
    got, gs = ce.conv_plain(_t(x), wt, bt, 1, ta, _t(r) if res else None,
                            tr if res else None)
    _check_out(got, pe.unpack_view(y))
    _check_sums(gs, _unpack_sums(sums, C), float(H * W))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("stats", [True, False], ids=["sums", "no_sums"])
def test_stem_bf16_plain_matches_jax_kernel(stride, stats):
    """Rows 13 and 12 (``_stem7_kernel``, ``_stem7s2_kernel``) on a bf16
    image, with and without the output sums (the batch-norm cnet)."""
    rng = np.random.default_rng(2)
    img = _bf(rng, (B, H, W, 3))
    jp, (wt, bt) = _conv(rng, 7, 3, C)
    fn = pe._stem_conv1_s2 if stride == 2 else pe._stem_conv1
    y, sums = fn(img, jp, JBF, want_stats=stats)
    got, gs = ce.conv_plain(_t(img), wt, bt, stride, want_stats=stats)
    _check_out(got, pe.unpack_view(y))
    if stats:
        _check_sums(gs, _unpack_sums(sums, C), float(H * W) / stride ** 2)
    else:
        assert gs is None and sums is None


def test_plane_stats_bf16_plain_matches_jax_kernel():
    """Row 10 (``_in_stats_kernel`` through ``_packed_stats``) on a bf16
    tensor: fp32 sums of the bf16 values."""
    rng = np.random.default_rng(3)
    x = _bf(rng, (B, H, W, C), 2.0, 0.5)
    want = _unpack_sums(pe._packed_stats(pe.pack_view(x)), C)
    got = ce.plane_stats(_t(x))
    _check_sums(got, want, float(H * W))


def _l2_weights(rng):
    jp, tp = _layer2_params(rng, C, CO)
    k1, kp = jp["c1"]["kernel"], jp["proj"]["kernel"]
    return jp, tp, (pl2.pack_weights3s2(k1).astype(JBF),
                    jp["c1"]["bias"].astype(JBF),
                    kp.reshape(kp.shape[-2:]).astype(JBF),
                    jp["proj"]["bias"].astype(JBF))


def test_l2_entry_bf16_plain_matches_jax_kernel():
    """Row 15 (``_l2_entry_kernel``: the stride-2 3x3 conv and the 1x1
    projection, both with sums) on the packed view of a post-relu
    input."""
    rng = np.random.default_rng(4)
    t_in = jnp.abs(_bf(rng, (B, H, W, C)))
    _, tp, packed = _l2_weights(rng)
    c1, p, s1a, s1b, spa, spb = pl2._l2_entry(pe.pack_view(t_in), *packed,
                                              JBF)
    gc1, gp, gs1, gsp = ce.entry_plain(_t(t_in), *tp["c1"], *tp["proj"])
    n = float(H // 2 * (W // 2))
    _check_out(gc1, c1)
    _check_out(gp, p)
    _check_sums(gs1, [s1a[:, 0], s1b[:, 0]], n)
    _check_sums(gsp, [spa[:, 0], spb[:, 0]], n)


@pytest.mark.parametrize("form", ["prep", "res_proj"])
def test_l2_conv_bf16_plain_matches_jax_kernel(form):
    """Row 16 (``_l2_conv_kernel`` / ``_l2_conv_res_kernel``) on layer2's
    flat NHWC tensors: prep, or relu((p*sp + tp) + prep(x)) with no relu
    on the projection term."""
    rng = np.random.default_rng(5)
    h2, w2 = H // 2, W // 2
    x = _bf(rng, (B, h2, w2, CO), 2.0, 0.3)
    p = _bf(rng, (B, h2, w2, CO), 2.0, -0.3)
    (ta, _, fa), (tr, _, fr) = _aff(rng, B, CO), _aff(rng, B, CO, False)
    jp, (wt, bt) = _conv(rng, 3, CO, CO)
    res = form == "res_proj"
    y, s1, s2 = pl2._l2_conv(x, fa, pl2.pack_weights3(jp["kernel"])
                             .astype(JBF), jp["bias"].astype(JBF), JBF,
                             res=p if res else None,
                             res_aff=fr if res else None)
    got, gs = ce.conv_plain(_t(x), wt, bt, 1, ta, _t(p) if res else None,
                            tr if res else None, res_relu=False)
    _check_out(got, y)
    _check_sums(gs, [s1[:, 0], s2[:, 0]], float(h2 * w2))


def test_l2_finish_bf16_plain_matches_jax_kernel():
    """Row 17 (``_l2_finish_kernel``): elementwise, each op rounded to
    bf16 in both, so bitwise equal."""
    rng = np.random.default_rng(6)
    shape = (B, H // 2, W // 2, CO)
    p, c2, c4 = (_bf(rng, shape, 2.0, s) for s in (-0.2, 0.3, 0.1))
    (tp, _, fp), (t2, _, f2), (t4, _, f4) = (
        _aff(rng, B, CO, False), _aff(rng, B, CO), _aff(rng, B, CO, False))
    want = pl2._l2_finish(p, fp, c2, f2, c4, f4, JBF)
    got = ce.l2_finish(_t(p), tp, _t(c2), t2, _t(c4), t4)
    assert got.dtype == BF and _np(want).max() > 0.5
    np.testing.assert_array_equal(_nhwc(got), _np(want))


def test_stage_finish_bf16_plain_is_per_op_rounding():
    """Row 11's plain version in bf16 rounds after every product and sum
    (the stage finish is an inline ``pallas_call``; part (b) holds it in
    the stage): relu(relu(t0 + u2) + v2) from bf16 terms, against the
    same formula written in numpy with a bf16 rounding after each op."""
    rng = np.random.default_rng(7)
    shape = (B, C, H, W)
    xs = [torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 2)
          .to(BF) for _ in range(3)]
    affs = [_aff(rng, B, C, i != 0)[0] for i in range(3)]
    got = ce.stage_finish(xs[0], affs[0], xs[1], affs[1], xs[2], affs[2])

    def r(v):
        return torch.from_numpy(v).to(BF).float().numpy()

    def prep(x, aff):
        s, t = (r(a.numpy())[:, :, None, None] for a in aff)
        return np.maximum(r(r(x.float().numpy() * s) + t), 0)

    t0, u2, v2 = (prep(x, a) for x, a in zip(xs, affs))
    want = np.maximum(r(np.maximum(r(t0 + u2), 0) + v2), 0)
    np.testing.assert_array_equal(_np(got), want)


# ------------------------------------------------------ (b) the stages

def _stage_case(name, rng):
    """(JAX output, port output) of one stage in bf16 on seeded inputs:
    ``test_torch_port_encoder.test_stage_matches_jax``'s nine cases."""
    if name.startswith(("conv1", "bn_conv1")):
        stride = 2 if name.endswith("s2") else 1
        img = _bf(rng, (B, H, W, 3))
        jc1, tc1 = _conv(rng, 7, 3, C)
        jp, tp = _convs(rng, ("c10", "c11", "c20", "c21"), 3, C, C)
        if name.startswith("bn"):
            ja, ta = _affines(rng, C)
            want = jax.jit(pe.bn_conv1_stem_layer1, static_argnums=(4, 5))(
                img, jc1, jp, ja, JBF, stride)
            got = es.bn_conv1_stem_layer1(_t(img), tc1, tp, ta, stride)
        else:
            want = jax.jit(pe.conv1_stem_layer1, static_argnums=(3, 4))(
                img, jc1, jp, JBF, stride)
            got = es.conv1_stem_layer1(_t(img), tc1, tp, stride)
    elif name in ("stem", "stem_border", "bn_stem"):
        shift = -0.7 if name == "stem_border" else 0.3
        y1 = _bf(rng, (B, H, W, C), 2.0, shift)
        jp, tp = _convs(rng, ("c10", "c11", "c20", "c21"), 3, C, C)
        if name == "bn_stem":
            ja, ta = _affines(rng, C)
            want = jax.jit(pe.bn_stem_layer1)(y1, jp, ja)
            got = es.bn_stem_layer1(_t(y1), tp, ta)
        else:
            want = jax.jit(pe.stem_layer1)(y1, jp)
            got = es.stem_layer1(_t(y1), tp)
    else:
        t_in = jnp.abs(_bf(rng, (B, H, W, C)))
        jp, tp = _layer2_params(rng, C, CO)
        if name == "layer2_bn":
            ja, ta = _affines(rng, CO)
            want = jax.jit(pl2.fused_layer2_bn, static_argnums=3)(
                t_in, jp, ja, JBF)
            got = es.fused_layer2_bn(_t(t_in), tp, ta)
        else:
            want = jax.jit(pl2.fused_layer2, static_argnums=2)(t_in, jp, JBF)
            got = es.fused_layer2(_t(t_in), tp)
    return want, got


# One stage chains up to five convs: a flipped bf16 output of one moves
# its neighbours in the next and, through an instance norm's fp32 sums,
# the rounding of its channel's affine.  Measured bitwise equal in all
# nine cases here; held with room for another CPU's summation order.
STAGE_ULPS, STAGE_EQUAL = 4.0, 0.9


@pytest.mark.parametrize("name", [
    "conv1_s1", "conv1_s2", "bn_conv1_s1", "bn_conv1_s2", "stem",
    "stem_border", "bn_stem", "layer2", "layer2_bn"])
def test_stage_bf16_matches_jax(name):
    """Each fused stage in bf16 against the JAX stage at ``dt=bfloat16``
    (its kernels in interpret mode): bf16 out, within ``STAGE_ULPS`` and
    at least ``STAGE_EQUAL`` of the elements equal."""
    want, got = _stage_case(name, np.random.default_rng(7))
    assert want.dtype == JBF
    _check_out(got, want, STAGE_ULPS, STAGE_EQUAL)


# ---------------------------------------------------- (c) the encoders

def _jax_model(fused, **kw):
    return JaxModel(JaxConfig(fused_encoder=fused, corr_implementation=
                              "pallas_alt", gru_backend="fused", **TINY,
                              **kw))


@pytest.fixture(scope="module")
def fused_vars():
    """The TINY model's variables, made with numpy from the tree's shapes
    (the fused model's tree is the plain one's: init takes the plain
    path)."""
    return _seeded_variables(jax.eval_shape(
        lambda k: _jax_model(True).init(k, image_hw=(32, 48)),
        jax.random.key(0)))


def _trunks(jm, jv, x, port, xt):
    """The fused part of an encoder (stem + layer1 + layer2) in both
    packages: (JAX, port)."""
    want = jm.apply(jv, x, method=lambda m, v: jenc._trunk_layer2(
        m, jenc._stem_layer1(m, v)))
    with torch.inference_mode():
        got = tenc._trunk_layer2(port, tenc._stem_layer1(port, xt))
    return want, got


# The fused trunk (stem + layer1 + layer2): the stages above, chained.
# Each stage alone is bitwise equal to JAX's here, but over a trunk the
# rare conv output that rounds to the other bf16 neighbour (conv1's
# 147-term sums: about 1 in 16,000 outputs) spreads through the convs
# after it and, through an instance norm's sums, into its channel's
# affine.  The whole encoder adds layer3 (and cnet's heads), the plain
# bf16 modules, whose norms round elsewhere than flax's in a few elements
# (``test_torch_port_bf16.test_encoders_bf16_match_jax`` holds them block
# by block and the whole plain fnet to 20 ulps).  Measured here and in
# the model test: trunks 1.6-8 ulps with 48-100% of the elements equal,
# whole encoders 1.1-16.5 ulps.
TRUNK_ULPS, TRUNK_EQUAL = 16.0, 0.3
ENCODER_ULPS = 24.0


@pytest.mark.parametrize("kind,ds", [("fnet", 2), ("cnet", 2), ("fnet", 3),
                                     ("cnet", 3)],
                         ids=["fnet", "cnet", "fnet_ds3", "cnet_ds3"])
def test_encoder_bf16_matches_jax(fused_vars, kind, ds):
    """``BasicEncoder`` (instance norm) and ``MultiBasicEncoder`` (frozen
    BN, running statistics moved off their init) fused in bf16 against
    the JAX encoders with ``fused_stem=True`` and ``dtype=bfloat16`` on
    one bf16 image at 32x48 (``n_downsample`` 2: the stride-1 conv1,
    row 13; 3: the stride-2 conv1, row 12, whose weights have the same
    shapes): the fused trunk, then every output head."""
    v = fused_vars
    x = _bf(np.random.default_rng(11), (1, 32, 48, 3))
    if kind == "fnet":
        jm = jenc.BasicEncoder(output_dim=256, norm_fn="instance",
                               downsample=ds, dtype=JBF, fused_stem=True)
        jv = {"params": v["params"]["fnet"]}
        want = [jax.jit(jm.apply)(jv, x)]
        port = _port_encoder(tenc.BasicEncoder, "fnet", v, output_dim=256,
                             norm_fn="instance", downsample=ds,
                             fused_stem=True)
    else:
        dims = (TINY["hidden_dims"],) * 2
        jm = jenc.MultiBasicEncoder(output_dims=dims, norm_fn="batch",
                                    downsample=ds, dtype=JBF,
                                    fused_stem=True)
        bs = jax.tree.map(lambda a: a + 0.3 * np.arange(a.size, dtype=a.dtype)
                          .reshape(a.shape) / a.size,
                          v["batch_stats"]["cnet"])
        jv = {"params": v["params"]["cnet"], "batch_stats": bs}
        want = [o for lvl in jax.jit(jm.apply)(jv, x) for o in lvl]
        port = _port_encoder(
            tenc.MultiBasicEncoder, "cnet",
            {"params": {"cnet": jv["params"]},
             "batch_stats": {"cnet": bs}},
            output_dims=dims, norm_fn="batch", downsample=ds, num_layers=3,
            fused_stem=True)
    _check_out(*reversed(_trunks(jm, jv, x, port, _t(x))), TRUNK_ULPS,
               TRUNK_EQUAL)
    with torch.inference_mode():
        out = port(_t(x))
    got = [out] if kind == "fnet" else [o for lvl in out for o in lvl]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _check_out(g, w, ENCODER_ULPS, 0.0, scale=0.0)


# ------------------------------------------------------- (d) the model

# 2 iterations, the encoders' outputs pinned to JAX's: the lookup, the
# update and the upsampling in bf16, held as test_torch_port_bf16's
# MODEL_TOL holds them behind the plain encoders.  Measured over two
# weight and two image seeds: 0.020-0.023 / 0.030-0.072 px, against a JAX
# bf16-vs-fp32 gap of 0.10-0.18 / 0.16-0.33 px (disparities O(5) px).
MODEL_TOL = (0.08, 0.12)


def test_model_bf16_fused_matches_jax(fused_vars):
    """The TINY model's test-mode forward, fused encoder in bf16 (bf16
    feature maps, the fused update), against the JAX model's at 32x48.

    The encoder outputs of the model's own forward: fnet's feature maps
    within ``ENCODER_ULPS``, and closer to the JAX fused model's than
    the JAX model with the plain bf16 encoders is (in max ulps, and in
    mean absolute difference by a factor 0.7; measured 7-16.5 against
    29.6-33 ulps, and 0.25-0.48 of the mean difference, over two weight
    and two image seeds); each encoder's fused trunk within
    ``TRUNK_ULPS``.  The fused stages are another numeric function than
    the plain ones (norms from fp32 sums of the unrounded output,
    E[x^2] - mean^2, a bf16 prep), so a port that ran the plain encoders
    would fail.

    The disparities after 2 iterations are compared with the encoder
    outputs pinned to the JAX fused model's, within ``MODEL_TOL``, which
    lies below JAX's own bf16-vs-fp32 gap (a port that ran fp32 would
    fail).  Unpinned, the plain bf16 modules after the trunks (layer3,
    cnet's heads) differ between the two frameworks by as much as the
    fused and plain trunks do, and random-weight GRU iterations grow
    either into disparity gaps of the same size (at 32x64, 3 iterations,
    over three image seeds: port vs JAX fused 1.2-4.2 px max, JAX plain
    vs fused 1.4-4.1 px), so an unpinned disparity cannot tell them
    apart."""
    v = fused_vars
    kw = dict(compute_dtype="bfloat16", corr_dtype="bfloat16")
    jm, plain, f32 = _jax_model(True, **kw), _jax_model(False, **kw), \
        _jax_model(True)
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(0, 255, (1, 32, 48, 3)).astype(np.float32)
            for _ in range(2)]

    def norm(img):
        return (2.0 * (jnp.asarray(img) / 255.0) - 1.0).astype(JBF)

    i1, i2 = norm(imgs[0]), norm(imgs[1])
    both = jnp.concatenate([i1, i2])
    jf = jm.fnet.apply(jm._split_vars(v, "fnet"), both)
    jc = jm.cnet.apply(jm._split_vars(v, "cnet"), i1,
                       num_layers=TINY["n_gru_layers"])
    pf = plain.fnet.apply(plain._split_vars(v, "fnet"), both)

    port = RAFTStereo(RAFTStereoConfig(fused_encoder=True, **TINY, **kw),
                      device="cpu")
    port.load_state_dict(variables_to_state_dict(v), strict=True)
    seen = {}
    fnet = port.fnet.forward
    port.fnet.forward = lambda x: seen.setdefault("fnet", fnet(x))
    port(*(torch.from_numpy(i) for i in imgs), iters=1)
    g = _nhwc(seen["fnet"])
    _check_out(seen["fnet"], jf, ENCODER_ULPS, 0.0)
    assert _ulps(g, jf).max() < _ulps(pf, jf).max()
    assert (np.abs(g - _np(jf)).mean()
            < 0.7 * np.abs(_np(pf) - _np(jf)).mean())
    for name, x in (("fnet", both), ("cnet", i1)):
        want, got = _trunks(getattr(jm, name), jm._split_vars(v, name), x,
                            getattr(port, name), _t(x))
        _check_out(got, want, TRUNK_ULPS, TRUNK_EQUAL)

    def fwd(m):  # unjitted, as the pinned encoder outputs were taken
        return [_np(o) for o in m.forward(v, *map(jnp.asarray, imgs),
                                          iters=2, test_mode=True)]

    want = fwd(jm)
    ref32 = [_np(o) for o in jax.jit(lambda v, a, b: f32.forward(
        v, a, b, iters=2, test_mode=True))(v, *map(jnp.asarray, imgs))]
    port.fnet.forward = lambda x: _t(jf)
    port.cnet.forward = lambda x: [[_t(o) for o in lvl] for lvl in jc]
    got = [_np(o) for o in port(*(torch.from_numpy(i) for i in imgs),
                                iters=2)]
    assert np.abs(want[0]).max() > 2.0  # a non-trivial comparison
    for g, w, r, tol in zip(got, want, ref32, MODEL_TOL):
        assert g.shape == w.shape and np.isfinite(g).all()
        assert np.abs(g - w).max() <= tol < np.abs(w - r).max()


# ----------------------------------- (e) the bf16 kernels' arithmetic

def _src(name):
    return " ".join(_build.source_text(name).split())


def _rbf(v) -> np.ndarray:
    """fp32 ``v`` rounded to bf16 (to nearest even), as fp32."""
    return torch.from_numpy(np.asarray(v, np.float32)).to(BF).float().numpy()


def kernel_prep(x, s, t, relu=True):
    """``prep_bf16`` of ``enc_conv_tc.cu`` and ``enc_finish.cu`` in numpy:
    the fp32 affine cast to bf16, then ``__fmul_rn`` and ``__fadd_rn``
    (fp32), each result rounded to bf16."""
    v = _rbf(_rbf(np.float32(x) * _rbf(s)) + _rbf(t))
    return np.where(v < 0, np.float32(0), v) if relu else v


def fma_prep(x, s, t, relu=True):
    """The same prep with ``x*s + t`` contracted into one fused
    multiply-add (one fp32 rounding of the exact x*s + t, then bf16)."""
    exact = (np.float64(x) * np.float64(_rbf(s)) + np.float64(_rbf(t)))
    v = _rbf(exact.astype(np.float32))
    return np.where(v < 0, np.float32(0), v) if relu else v


def test_source_rounds_after_each_prep_op():
    """The kernels' prep rounds the product and the sum separately (the
    text of ``prep_bf16``) and adds the residual terms with one rounding
    more; the emulation of that prep is bitwise the plain version's, and
    an FMA-contracted prep is not, on seeded data: so the comparison would
    catch a kernel that nvcc let contract."""
    for name in ("enc_conv_tc", "enc_finish"):
        assert "rbf(__fadd_rn(rbf(__fmul_rn(x, " in _src(name), name
    assert "v = relu(rbf(__fadd_rn(u, v)));" in _src("enc_conv_tc")
    rng = np.random.default_rng(12)
    x = _rbf(rng.normal(size=(B, C, H, W)) * 3)
    r = _rbf(rng.normal(size=(B, C, H, W)) * 3)
    (ta, _, _), (tr, _, _) = _aff(rng, B, C, False), _aff(rng, B, C, False)
    s, t = (a.numpy()[:, :, None, None] for a in ta)
    rs, rt = (a.numpy()[:, :, None, None] for a in tr)
    xt, rtt = torch.from_numpy(x).to(BF), torch.from_numpy(r).to(BF)
    want = _np(ce.prep(xt, ta))
    np.testing.assert_array_equal(kernel_prep(x, s, t), want)
    fma = fma_prep(x, s, t)
    assert np.mean(fma != want) > 0.01
    for res_relu in (True, False):  # kRes, kResProj
        got = np.maximum(_rbf(kernel_prep(r, rs, rt, res_relu)
                              + kernel_prep(x, s, t)), 0)
        plain = torch.relu(ce.prep(rtt, tr, relu=res_relu) + ce.prep(xt, ta))
        np.testing.assert_array_equal(got, _np(plain))


def _unswizzle16(pack):
    """Undo the bf16 pack's half swap: in rows whose output index has bit
    2 set, the two 8-channel halves trade places."""
    bn = pack.shape[-2]
    swap = ((torch.arange(bn) >> 2) & 1).bool()
    return torch.where(swap[:, None], pack.roll(8, -1), pack)


@pytest.mark.parametrize("cout,cin", [(64, 64), (64, 20), (32, 64),
                                      (96, 33)],
                         ids=["row9", "ragged_cin", "ragged_cout", "ragged"])
def test_bf16_pack_unpacks_to_bf16_weights(cout, cin):
    """``tc_pack_bf16`` (row 9's bf16 form): (tiles of bn outputs, stages
    of 16 channels (the source's ``kKCB``), 9 taps, bn, 16) bf16; every
    weight rounded to bf16 once at its place, zero past Cout and Cin."""
    src = _src("enc_conv_tc")
    assert f"kKCB = {ce.TC_STAGE_BF16};" in src
    assert "kBBytes = 9 * kTapBytes; // a stage's weights" in src
    rng = np.random.default_rng(cout + cin)
    w = torch.from_numpy(rng.normal(size=(cout, cin, 3, 3))
                         .astype(np.float32))
    bn = ce.TC_INSTANCES["stage_conv"][3]
    pack = ce.tc_pack_bf16(w, bn)
    nt, nk, taps, pbn, kc = pack.shape
    assert pack.dtype == BF and (pbn, kc, taps) == (bn, 16, 9)
    assert (nt, nk) == (-(-cout // bn), -(-cin // 16))
    u = _unswizzle16(pack).permute(0, 3, 2, 1, 4).reshape(
        nt * bn, taps, nk * 16)                       # (o, tap, c)
    assert not u[cout:].any() and not u[:, :, cin:].any()
    got = u[:cout, :, :cin].reshape(cout, 3, 3, cin).permute(0, 3, 1, 2)
    assert torch.equal(got, w.to(BF))


def _row_off(p, u):
    """``row_off`` of the sources: byte offset of 16-byte half u of
    32-byte row p, the halves swapped where bit 2 of p is set."""
    return p * 32 + ((((u ^ (p >> 2)) & 1)) << 4)


def _ldmatrix_x4(image, addrs):
    """``ldmatrix.sync.aligned.m8n8.x4.shared.b16`` on a shared-memory
    image of b16 values: lanes 8m..8m+7 give matrix m's row addresses
    (bytes); lane T receives, in register m, the two values at row T // 4,
    columns 2 (T % 4) and + 1 of matrix m.  Returns (32, 4, 2)."""
    out = np.zeros((32, 4, 2), image.dtype)
    for lane in range(32):
        for m in range(4):
            a = addrs[8 * m + lane // 4] // 2 + 2 * (lane % 4)
            out[lane, m] = image[a:a + 2]
    return out


def test_bf16_fragments_are_the_mma_operands():
    """The m16n8k16 operands the kernels' ``ldmatrix`` addressing gives
    (the fp32 kernels' addresses, a 16-byte half being channels 0-7 or
    8-15 of a k-step): A from a stage's tile as the fill stores it (pixel
    p's channel octet q at ``row_off(p, q)``): a0..a3 = rows g, g + 8 at
    k 2t, 2t+1 and + 8; B from a tap block of the bf16 pack copied
    verbatim: per n-tile b0 = k 2t, 2t+1 and b1 = k + 8 of column g."""
    src = _src("enc_conv_tc")
    for text in ("const int r16 = (lane & 7) + (((lane >> 3) & 1) << 3);",
                 "const int a_u = lane >> 4;",
                 "const int b_row = wn * 8 * NT + (lane & 7) + "
                 "((lane >> 4) << 3);",
                 "row_off(b_row, (lane >> 3) & 1)", "plane + row_off(p, a_u)",
                 "blk + b_off + 16 * jp * kRow", "row_off(sp, q)"):
        assert text in src, text
    rng = np.random.default_rng(3)
    npix = 40
    vals = rng.integers(0, 2 ** 16, (npix, 16)).astype(np.uint16)
    image = np.zeros(npix * 16, np.uint16)
    for p in range(npix):
        for q in range(2):
            o = _row_off(p, q) // 2
            image[o:o + 8] = vals[p, 8 * q:8 * q + 8]
    for p0 in (0, 5, 24):
        regs = _ldmatrix_x4(image, [
            _row_off(p0 + (lane & 7) + (((lane >> 3) & 1) << 3), lane >> 4)
            for lane in range(32)])
        for lane in range(32):
            g, t = divmod(lane, 4)
            for m, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                np.testing.assert_array_equal(
                    regs[lane, m], vals[p0 + g + dr, 2 * t + dk:2 * t + dk + 2])
    w = torch.from_numpy(rng.normal(size=(64, 16, 3, 3)).astype(np.float32))
    pack = ce.tc_pack_bf16(w, 64)
    for tap in (0, 4, 8):
        block = pack[0, 0, tap].contiguous().view(torch.int16).numpy()
        block = block.reshape(-1).view(np.uint16)
        wt = w[:, :, tap // 3, tap % 3].to(BF).view(torch.int16).numpy()
        nt = 4  # row 9: 2 warps x 4 n-tiles of 8 outputs
        for wn in range(2):
            for jp in range(nt // 2):
                regs = _ldmatrix_x4(block, [
                    _row_off(wn * 8 * nt + (lane & 7) + ((lane >> 4) << 3),
                             (lane >> 3) & 1) + 16 * jp * 32
                    for lane in range(32)])
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for m in range(4):  # (n-tile 2jp, 2jp+1) x (b0, b1)
                        n = wn * 8 * nt + 8 * (2 * jp + m // 2) + g
                        k = 2 * t + 8 * (m % 2)
                        assert list(regs[lane, m].view(np.int16)) == list(
                            wt[n, k:k + 2]), (tap, wn, jp, lane, m)


@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_stem_k_padding_and_gathers(stride):
    """The bf16 stem: K = 147 in (ci, dy, dx) order padded to 160 (10
    k-steps of 16, the source's ``kStemKStepsB``); the weights' shared
    image (row n, k-step k / 16, position k % 16 at ``row_off(n, (k >> 3)
    & 1) + (k & 7) * 2``) gives B fragments of the OIHW weights with zero
    at the pad; the A registers gathered through the table (a pad k's
    offset: the zeros past the staged plane) are the im2col of the
    zero-padded image, zero at the pad, for every pixel of a tile."""
    src = _src("enc_conv")
    for text in ("kStemKStepsB = (kStemK + 15) / 16",
                 "row_off(n, (k >> 3) & 1) + (k & 7) * 2",
                 "const int o0 = tab[16 * s + 2 * t], "
                 "o1 = tab[16 * s + 2 * t + 1];",
                 "const int o2 = tab[16 * s + 2 * t + 8], "
                 "o3 = tab[16 * s + 2 * t + 9];",
                 "ph[q + o0] | ((uint32_t)ph[q + o1] << 16)",
                 "ph[q + 8 + o0] | ((uint32_t)ph[q + 8 + o1] << 16)",
                 ": G::kPlane;"):
        assert text in src, text
    from test_torch_port_stem_tc import gather_offset, stem_constants

    c = stem_constants(stride)
    kk, steps = 147, -(-147 // 16)
    assert steps == 10
    rng = np.random.default_rng(stride)
    w = rng.normal(size=(64, 3, 7, 7)).astype(np.float32)
    wf = w.reshape(64, kk)
    image = np.zeros(steps * 64 * 16, np.float32)
    for n in range(64):
        for k in range(16 * steps):
            o = ((k // 16) * 64 * 32 + _row_off(n, (k >> 3) & 1)
                 + (k & 7) * 2) // 2
            image[o] = wf[n, k] if k < kk else 0.0
    for s in range(steps):
        block = image[s * 64 * 16:(s + 1) * 64 * 16]
        for jp in range(2):
            regs = _ldmatrix_x4(block, [
                _row_off((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1)
                + 16 * jp * 32 for lane in range(32)])
            for lane in range(32):
                g, t = divmod(lane, 4)
                for m in range(4):
                    n, k = 8 * (2 * jp + m // 2) + g, 16 * s + 2 * t + 8 * (
                        m % 2)
                    want = [wf[n, j] if j < kk else 0.0 for j in (k, k + 1)]
                    assert list(regs[lane, m]) == want
    # the gathers: a staged plane of the zero-padded image (its unused
    # slots and the zeros past it 0), the table, the pixels' bases
    h, w_ = 8 * stride + 6, 32 * stride + 6
    img = rng.normal(size=(3, h, w_)).astype(np.float32)
    ih, iw, ps, half = c["IH"], c["IW"], c["PS"], c["HALF"]
    plane = np.zeros(3 * ih * iw + c["kZeros"], np.float32)
    for ci in range(3):
        for r in range(ih):
            for q in range(iw):
                col = q % ps
                j = col * stride + q // ps
                if col < half and r < h and j < w_:
                    plane[(ci * ih + r) * iw + q] = img[ci, r, j]
    tab = [gather_offset(((k // 49, k % 49 // 7, k % 7) if k < kk else None),
                         stride) for k in range(16 * steps)]
    assert tab[kk:] == [3 * ih * iw] * (16 * steps - kk)
    cols = F.unfold(torch.from_numpy(img)[None], 7, stride=stride)[0]
    cols = F.pad(cols, (0, 0, 0, 16 * steps - kk)).numpy()  # (160, pixels)
    wo = (w_ - 7) // stride + 1
    for mt in range(16):  # the tile's 16 m-tiles: 8 rows x 2
        for g in range(16):  # rows g and g + 8 of the m-tile
            base = (mt // 2) * stride * iw + (mt % 2) * 16 + g
            pix = (mt // 2) * wo + (mt % 2) * 16 + g
            np.testing.assert_array_equal(
                plane[[base + o for o in tab]], cols[:, pix])


def emulate_conv_bf16(x, weight, bias, stride=1, aff=None, res=None,
                      res_aff=None, res_relu=True, k_group=None):
    """The bf16 convolutions' arithmetic: the prep of ``kernel_prep``
    (rounded after each op) zero-padded after it; per stage of 16 input
    channels (rows 9, 15, 16: all 9 taps), or per ``k_group`` K indices
    in (ci, dy, dx) order (the stems: 4 k-steps of 16), the exact products
    summed fresh (float64, rounded to fp32 once: the tensor cores' fp32
    sum) and added to the fp32 total in order; the bf16 bias added in
    fp32; returns (y rounded to bf16, the fp32 y)."""
    xb = x.float().numpy()
    if aff is not None:
        s, t = (a.numpy()[:, :, None, None] for a in aff)
        xb = kernel_prep(xb, s, t)
        if res is not None:
            rs, rt = (a.numpy()[:, :, None, None] for a in res_aff)
            xb = np.maximum(_rbf(kernel_prep(res.float().numpy(), rs, rt,
                                             res_relu) + xb), 0)
    k = weight.shape[-1]
    t = torch.from_numpy(xb).double()
    wd = weight.to(BF).double()
    parts = []
    if k_group is None:
        parts = [F.conv2d(t[:, c0:c0 + 16], wd[:, c0:c0 + 16], None, stride,
                          k // 2).float() for c0 in range(0, x.shape[1], 16)]
    else:
        ho = (x.shape[2] - 1) // stride + 1
        cols = F.unfold(t, k, padding=k // 2, stride=stride)  # (ci, dy, dx)
        wf = wd.reshape(wd.shape[0], -1)
        for k0 in range(0, wf.shape[1], k_group):
            part = torch.einsum("ok,bkl->bol", wf[:, k0:k0 + k_group],
                                cols[:, k0:k0 + k_group]).float()
            parts.append(part.reshape(x.shape[0], -1, ho, part.shape[-1] // ho))
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    y = acc + bias.to(BF).float()[:, None, None]
    return y.to(BF), y


@pytest.mark.parametrize("form", ["stem", "stem_s2", "prep", "res",
                                  "res_proj", "entry"])
def test_bf16_conv_emulation_matches_plain(form):
    """The emulated arithmetic of each bf16 conv (row 13 and 12's 7x7 over
    the raw image, K in stages of 4 k-steps of 16; rows 9 and 16's 3x3 in
    stages of 16 channels, prep, residual and residual-projection; row
    15's stride-2 entry) against ``conv_plain`` in bf16: within 1 ulp, at
    least 99% equal (fp32 sums in another order), sums within
    ``SUMS_TOL``."""
    rng = np.random.default_rng(21)
    cin = 3 if form.startswith("stem") else 40
    x = torch.from_numpy(rng.normal(size=(B, cin, H, W)).astype(np.float32)
                         * 2).to(BF)
    r = torch.from_numpy(rng.normal(size=(B, cin, H, W)).astype(np.float32)
                         * 2).to(BF)
    k = 7 if form.startswith("stem") else 3
    w = torch.from_numpy((rng.normal(size=(32, cin, k, k))
                          / np.sqrt(cin * k * k)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=32).astype(np.float32) * 0.1)
    aff, raff = _aff(rng, B, cin)[0], _aff(rng, B, cin, False)[0]
    stride = 2 if form in ("stem_s2", "entry") else 1
    kw = {}
    if form in ("prep", "res", "res_proj"):
        kw = dict(aff=aff)
    if form in ("res", "res_proj"):
        kw.update(res=r, res_aff=raff, res_relu=form == "res")
    got, y32 = emulate_conv_bf16(
        x, w, bias, stride, k_group=64 if form.startswith("stem") else None,
        **kw)
    want, sums = ce.conv_plain(x, w, bias, stride, **kw)
    g, wv = _np(got), _np(want)
    assert np.abs(wv).max() > 0.5
    assert (np.abs(g - wv) / np.maximum(1, np.abs(wv))).max() <= ULP
    assert np.mean(g == wv) >= KERNEL_EQUAL
    n = float(want.shape[2] * want.shape[3])
    _check_sums(sums, ce.stats_plain(y32), n)
