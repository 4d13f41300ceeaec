"""The port's bf16 training (``compute_dtype="bfloat16"``, the JAX
package's ``--mixed_precision``) against the JAX package on the CPU.

Inputs are made with numpy from a seed and passed to both packages; the
JAX side runs its Pallas kernels and their custom VJPs in interpret mode
(automatic off the TPU) and its flax modules with ``dtype=bfloat16``; the
port runs its plain versions.  One bf16 ulp of a value v is 2^-7 *
max(1, |v|) here.

From the bottom up: row 4's bf16 plain versions (the lookup's backward,
radial and general taps) bitwise against the TPU kernel's VJP, with a
variant that skips the bf16 rounding of the coefficient failing the same
check; the VJPs of the module step's bf16 pieces and of the plain
encoders, block by block, on the same inputs and cotangents; then the
model in bf16 train mode with its encoders' outputs pinned to JAX's (as
``test_torch_port_bf16.py`` pins them for the forward), held against
``jax.grad`` of the JAX bf16 model within a tolerance below JAX's own
bf16-vs-fp32 gap on the same inputs; one optimizer step; and the CLI.
(The fused encoder and the bf16 ``pallas`` volume in training:
``test_torch_port_enc_bf16_train.py``.)
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_encoder_train import _seeded_variables
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse

from raftstereo_tpu import RAFTStereoConfig as JaxConfig
from raftstereo_tpu.config import TrainConfig as JaxTrainConfig
from raftstereo_tpu.models import RAFTStereo as JaxModel
from raftstereo_tpu.models.encoders import BasicEncoder as JaxBasicEncoder
from raftstereo_tpu.models.encoders import \
    MultiBasicEncoder as JaxMultiEncoder
from raftstereo_tpu.models.layers import InstanceNorm as JaxInstanceNorm
from raftstereo_tpu.models.update import ConvGRU as JaxConvGRU
from raftstereo_tpu.ops import corr as jcorr
from raftstereo_tpu.ops import pallas_alt as jalt
from raftstereo_tpu.ops.image import \
    resize_bilinear_align_corners as jresize
from raftstereo_tpu.train.loss import sequence_loss as jax_sequence_loss
from raftstereo_tpu.train.optim import make_optimizer as jax_make_optimizer
from raftstereo_tpu.train.state import state_from_variables
from raftstereo_tpu.train.step import make_train_step as jax_make_step
from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig
from raftstereo_tpu_torch.cli import profile as cli_profile
from raftstereo_tpu_torch.cli import train as cli_train
from raftstereo_tpu_torch.config import TrainConfig
from raftstereo_tpu_torch.models.layers import conv_bf16, instance_norm_bf16
from raftstereo_tpu_torch.models.update import ConvGRU
from raftstereo_tpu_torch.ops import alt_lookup as talt
from raftstereo_tpu_torch.ops import bf16 as tbf16
from raftstereo_tpu_torch.ops.corr import build_corr_state, corr_lookup
from raftstereo_tpu_torch.ops.cuda_gru import sigmoid_bf16, tanh_bf16
from raftstereo_tpu_torch.ops.image import resize_bilinear_align_corners
from raftstereo_tpu_torch.train.loss import sequence_loss
from raftstereo_tpu_torch.train.optim import make_optimizer
from raftstereo_tpu_torch.train.state import TrainState
from raftstereo_tpu_torch.train.step import make_train_step
from raftstereo_tpu_torch.utils.convert import variables_to_state_dict

BF = torch.bfloat16
JBF = jnp.bfloat16
ULP = 2.0 ** -7
TINY = dict(n_gru_layers=3, hidden_dims=(32, 32, 32), corr_levels=2,
            corr_radius=2)
HW = (32, 48)
ITERS = 3
# chip_smoke.py's BACKWARD_TOL for the fp32 form (sums of fp32 products
# in another order).
BACKWARD_TOL = 1e-4


def _np(a) -> np.ndarray:
    """float32 numpy copy of a JAX array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf(a) -> torch.Tensor:
    """bf16 torch copy of a (bf16-valued) array."""
    return torch.from_numpy(_np(a).copy()).to(BF)


def _ulps(got, want) -> np.ndarray:
    got, want = _np(got), _np(want)
    return np.abs(got - want) / np.maximum(1.0, np.abs(want)) / ULP


def _equal_share(got, want) -> float:
    got, want = _np(got), _np(want)
    ok = np.isfinite(want)
    return float(np.mean(got[ok] == want[ok]))


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


# ------------------------------------------------------ row 4, radial

LEVELS, RADIUS = 4, 4


def _radial_inputs(field: str):
    """bf16-valued feature maps (2 images, 4 rows of 48 pixels, C=256),
    coordinates and a cotangent.  ``random``: disparities U(0, 20) px,
    taps past both edges and a NaN coordinate; ``smooth``: one slowly
    varying disparity over every row."""
    rng = np.random.default_rng(11)
    b, h, w, c = 2, 4, 48, 256
    f1, f2 = (np.asarray(jnp.asarray(rng.normal(size=(b, h, w, c)))
                         .astype(JBF).astype(jnp.float32))
              for _ in range(2))
    if field == "random":
        x = (np.arange(w) - rng.uniform(0, 20, (b, h, w))).astype(np.float32)
        x[0, 0, :3] = [-200.5, w + 200.25, w - 0.5]
        x[1, 3, 7] = np.nan
    else:
        x = np.broadcast_to(np.arange(w) * 1.01 - 7.3, (b, h, w)).astype(
            np.float32).copy()
    g = rng.normal(size=(b, h, w, LEVELS * (2 * RADIUS + 1))).astype(
        np.float32)
    return f1, f2, x, g


def _radial_jax(f1, f2, x, g, dtype, out_dtype):
    """jax.vjp of the Pallas radial lookup (its ``_alt_pyr_bwd_kernel``
    in interpret mode) w.r.t. fmap1 and fmap2 in ``dtype``, for the
    cotangent g in ``out_dtype``."""
    fn = jax.vjp(lambda a, b: jcorr.make_pallas_alt_corr_fn(
        a, b, LEVELS, RADIUS, dtype=dtype, out_dtype=out_dtype)(
            jnp.asarray(x)[..., None]),
        jnp.asarray(f1).astype(dtype), jnp.asarray(f2).astype(dtype))[1]
    return fn(jnp.asarray(g).astype(out_dtype))


def _radial_port(f1, f2, x, g, dtype, out_dtype):
    """The port's differentiable lookup (``corr_lookup``: the backward's
    plain version, then autograd through the pyramid's pooling)."""
    t1, t2 = (torch.from_numpy(a.copy()).to(dtype).requires_grad_()
              for a in (f1, f2))
    st = build_corr_state(t1, t2, LEVELS, "pallas_alt", corr_dtype=dtype)
    out = corr_lookup(st, torch.from_numpy(x), RADIUS, out_dtype)
    assert out.dtype == out_dtype
    out.backward(_bf(g).to(out_dtype))
    return t1.grad, t2.grad


@pytest.mark.parametrize("field", ["random", "smooth"])
def test_radial_bf16_plain_matches_jax(field):
    """bf16 maps, bf16 cotangent: the plain version rounds the scaled
    coefficient to bf16 once, as the TPU kernel rounds ``dm``, so df1 and
    df2 (through the pooling) are bitwise equal to JAX's (measured: every
    element); held to 99% equal and 1 ulp.  The same values without that
    rounding (the fp32 form on the bf16 maps' values, the gradients
    rounded to bf16 at the end) land on the other side of a bf16 rounding
    boundary for 40-50% of the elements (measured) and fail the check."""
    f1, f2, x, g = _radial_inputs(field)
    want = _radial_jax(f1, f2, x, g, JBF, JBF)
    got = _radial_port(f1, f2, x, g, BF, BF)
    skip = _radial_port(f1, f2, x, g, torch.float32, torch.float32)
    for a, s, w in zip(got, skip, want):
        assert a.dtype == BF and w.dtype == JBF
        assert np.array_equal(np.isnan(_np(a)), np.isnan(_np(w)))
        ok = np.isfinite(_np(w))
        assert _ulps(_np(a)[ok], _np(w)[ok]).max() <= 1.0
        assert _equal_share(a, w) >= 0.99
        assert _equal_share(s.to(BF), w) < 0.9
    if field == "random":
        assert np.isnan(_np(got[0])[1, 3, 7]).all()


def test_radial_fp32_maps_bf16_cotangent_matches_jax():
    """fp32 maps with a bf16 output (``corr_dtype="float32"`` in a bf16
    model): the bf16 cotangent is widened to fp32, exactly, and the fp32
    form runs, as the TPU kernel widens it; fp32 gradients within the fp32
    form's ``BACKWARD_TOL`` of JAX's."""
    f1, f2, x, g = _radial_inputs("random")
    want = _radial_jax(f1, f2, x, g, jnp.float32, JBF)
    got = _radial_port(f1, f2, x, g, torch.float32, BF)
    for a, w in zip(got, want):
        a, w = _np(a), np.asarray(w)
        assert w.dtype == np.float32
        assert np.array_equal(np.isnan(a), np.isnan(w))
        ok = np.isfinite(w)
        scale = max(1.0, float(np.abs(w[ok]).max()))
        assert float(np.abs(a[ok] - w[ok]).max()) <= BACKWARD_TOL * scale


# ----------------------------------------------------- row 4, general

def _general_inputs(field: str):
    """Two rows of 40 pixels, C=256, levels 40/20 with 9 taps each.
    ``repeat``: each pixel's taps hit some columns with several taps that
    are not consecutive (t, t + 3.25, t + 0.5, ...), the case where the
    coefficient must be summed per column before it is rounded; plus a
    NaN tap.  ``random``: taps U(-3, w + 2)."""
    rng = np.random.default_rng(12)
    n, w1, c, widths, kk = 2, 40, 256, (40, 20), 9
    f1 = np.asarray(jnp.asarray(rng.normal(size=(n, w1, c))).astype(JBF)
                    .astype(jnp.float32))
    f2s = [np.asarray(jnp.asarray(rng.normal(size=(n, w, c))).astype(JBF)
                      .astype(jnp.float32)) for w in widths]
    if field == "repeat":
        base = rng.uniform(0, 30, (n, w1, 1))
        offs = np.array([0.0, 3.25, 0.5, 1.0, 3.75, 0.25, 7.0, 1.5, 0.75])
        t0 = (base + offs).astype(np.float32)
        taps = np.concatenate([t0, (t0 * 0.5).astype(np.float32)], -1)
        taps[1, 5, 4] = np.nan
    else:
        taps = np.concatenate(
            [rng.uniform(-3, w + 2, (n, w1, kk)) for w in widths],
            -1).astype(np.float32)
    g = rng.normal(size=taps.shape).astype(np.float32)
    return f1, f2s, taps, g, widths


def _general_jax(f1, f2s, taps, g):
    """jax.vjp through ``pallas_alt_pyramid_flat`` (the custom VJP
    ``_make_alt_pyr``, its backward kernel in interpret mode) w.r.t. the
    bf16 fmap1 and each bf16 level, levels padded to the TPU's lanes."""
    n, w1, lk = taps.shape
    padded = tuple(-(-f.shape[1] // 128) * 128 for f in f2s)

    def fn(a, *levels):
        f2cat = jnp.concatenate([jalt.pad_w2_lane(jalt.preflatten_fmap2(
            lv[None])) for lv in levels], axis=1)
        return jalt.pallas_alt_pyramid_flat(
            jalt.preflatten_fmap1(a[None]), f2cat,
            jnp.asarray(taps)[None], padded, out_dtype=JBF)

    _, vjp = jax.vjp(fn, jnp.asarray(f1).astype(JBF),
                     *(jnp.asarray(f).astype(JBF) for f in f2s))
    out = vjp(jnp.asarray(g).astype(JBF)[None])
    return out[0], jnp.concatenate(out[1:], axis=1)


@pytest.mark.parametrize("field", ["repeat", "random"])
def test_general_bf16_plain_matches_jax(field):
    """bf16 maps: each pixel's coefficient on a column (its taps' terms
    summed in tap order, scaled) rounded to bf16 once, as the TPU kernel
    rounds ``dm``; bitwise equal to JAX (measured: every element), held
    to 99% equal and 1 ulp, NaN where JAX has NaN.  Without the rounding
    the check fails."""
    f1, f2s, taps, g, widths = _general_inputs(field)
    want = _general_jax(f1, f2s, taps, g)
    f2cat = np.concatenate(f2s, axis=1)
    t = (torch.from_numpy(a.copy()) for a in (f1, f2cat, taps, g))
    tf1, tf2, ttaps, tg = t
    got = talt.alt_corr_taps_backward_plain(tf1.to(BF), tf2.to(BF), ttaps,
                                            tg.to(BF), widths)
    skip = talt.alt_corr_taps_backward_plain(tf1, tf2, ttaps,
                                             tg.to(BF).float(), widths)
    for a, s, w in zip(got, skip, want):
        assert a.dtype == BF and w.dtype == JBF
        assert np.array_equal(np.isnan(_np(a)), np.isnan(_np(w)))
        ok = np.isfinite(_np(w))
        assert _ulps(_np(a)[ok], _np(w)[ok]).max() <= 1.0
        assert _equal_share(a, w) >= 0.99
        assert _equal_share(s.to(BF), w) < 0.9
    if field == "repeat":
        assert np.isnan(_np(got[0])[1, 5]).all()


def test_general_bf16_autograd_reaches_both_maps():
    """``pallas_alt_pyramid_flat`` with bf16 maps is differentiable: the
    gradients come back in bf16 and equal the plain VJP's; the taps get
    zero, as ``_make_alt_pyr.bwd`` returns."""
    f1, f2s, taps, g, widths = _general_inputs("random")
    a = torch.from_numpy(f1).to(BF).requires_grad_()
    b = torch.from_numpy(np.concatenate(f2s, 1)).to(BF).requires_grad_()
    tp = torch.from_numpy(taps).requires_grad_()
    out = talt.pallas_alt_pyramid_flat(a, b, tp[None], widths,
                                       out_dtype=BF)
    out.backward(_bf(g)[None])
    want = talt.alt_corr_taps_backward_plain(a.detach(), b.detach(),
                                             tp.detach(), _bf(g), widths)
    assert a.grad.dtype == b.grad.dtype == BF
    assert torch.equal(a.grad, want[0]) and torch.equal(b.grad, want[1])
    assert torch.equal(tp.grad, torch.zeros_like(tp))


# ------------------------------------------------- module-step pieces

def _sum_seq(x: torch.Tensor, dims) -> torch.Tensor:
    """A bf16 sum over ``dims`` as XLA:CPU takes one: an add at a time,
    each rounded to bf16, over the reduced positions in row-major order
    (batch, height, width of NHWC).  The port's ``ops.bf16.sum32``
    accumulates in fp32 and rounds once, as an accelerator does; patching
    this in shows every other rounding point of a VJP to be JAX's."""
    dims = sorted(d % x.dim() for d in dims)
    if x.dim() == 4 and dims == [0, 2, 3]:  # NCHW: NHWC's row-major order
        dims = [0, 2, 3]
    keep = [d for d in range(x.dim()) if d not in dims]
    rows = x.permute(*dims, *keep).reshape(-1, *[x.shape[d] for d in keep])
    acc = torch.zeros_like(rows[0])
    for r in rows:
        acc = acc + r
    shape = [1 if d in dims else x.shape[d] for d in range(x.dim())]
    return acc.reshape(shape)


@pytest.fixture
def cpu_sums(monkeypatch):
    """The port's bf16 image sums taken as XLA:CPU takes them."""
    monkeypatch.setattr(tbf16, "sum32", _sum_seq)

def _vjp_pair(jfn, tfn, *xs, seed=0):
    """``jax.vjp`` of ``jfn`` and torch autograd of ``tfn`` on the same
    bf16 inputs ``xs`` (numpy) and one seeded bf16 cotangent; returns the
    outputs and the input cotangents of both."""
    jx = [jnp.asarray(x).astype(JBF) for x in xs]
    y, vjp = jax.vjp(jfn, *jx)
    g = jnp.asarray(np.random.default_rng(seed).normal(size=y.shape)).astype(
        y.dtype)
    jd = vjp(g)
    tx = [_bf(x).requires_grad_() for x in jx]
    ty = tfn(*tx)
    ty.backward(_bf(g).to(ty.dtype))
    return (y, jd), (ty, [t.grad for t in tx])


@pytest.mark.parametrize("name", ["sigmoid", "tanh", "relu"])
def test_activation_vjps_bitwise(name):
    """JAX's differentiation rules in bf16: sigmoid ``g * (ans * (1 -
    ans))``, tanh ``u + u * ans`` with ``u = g * (1 - ans)``, each
    operation rounded; relu ``g`` where x > 0.  The port's custom
    backward gives every bit (torch's own sigmoid and tanh backward differ
    for about two thirds and two fifths of the elements)."""
    jfn, tfn = {"sigmoid": (jax.nn.sigmoid, sigmoid_bf16),
                "tanh": (jnp.tanh, tanh_bf16),
                "relu": (jax.nn.relu, torch.relu)}[name]
    x = np.random.default_rng(1).normal(size=(2, 8, 16, 32)) * 3
    (y, (jd,)), (ty, (td,)) = _vjp_pair(jfn, tfn, x)
    assert ty.dtype == td.dtype == BF
    assert np.array_equal(_np(ty), _np(y))
    assert np.array_equal(_np(td), _np(jd))


@pytest.mark.parametrize("sums", ["fp32", "cpu"])
def test_conv_bf16_vjp_matches_flax(sums, monkeypatch):
    """flax ``nn.Conv(dtype=bfloat16)``'s VJP: the output, dx (bf16) and
    the kernel's gradient (bf16, then fp32 through the parameter's cast)
    within 1 ulp with at least 99.9% equal (conv sums in another order;
    measured 99.99%, 0.6 ulp).  The bias's gradient is a bf16 sum over the
    batch and pixels: XLA:CPU adds it one row at a time, rounding every
    add (up to ~120 ulps from the exact sum here), where the port, and XLA
    on an accelerator, accumulate in fp32 and round once.  With the
    port's sums it is bitwise the fp32 sum of JAX's cotangent rounded
    once; with the sums taken as XLA:CPU takes them, bitwise JAX's."""
    if sums == "cpu":
        monkeypatch.setattr(tbf16, "sum32", _sum_seq)
    import flax.linen as nn

    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, 24, 32)).astype(np.float32)
    xj = jnp.asarray(x).astype(JBF)
    conv = nn.Conv(48, (3, 3), padding=((1, 1), (1, 1)), dtype=JBF)
    v = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32) * 0.1),
        conv.init(jax.random.key(0), xj))
    y, vjp = jax.vjp(lambda vv, a: conv.apply(vv, a), v, xj)
    g = jnp.asarray(rng.normal(size=y.shape)).astype(JBF)
    dv, dx = vjp(g)
    w = torch.from_numpy(np.asarray(v["params"]["kernel"])).permute(
        3, 2, 0, 1).contiguous().requires_grad_()
    b = torch.from_numpy(np.asarray(v["params"]["bias"])).requires_grad_()
    xt = _nchw(_bf(xj)).contiguous().requires_grad_()
    yt = conv_bf16(xt, w, b, padding=1)
    yt.backward(_nchw(_bf(g)))
    assert xt.grad.dtype == BF and w.grad.dtype == b.grad.dtype == \
        torch.float32
    for got, want in ((_nhwc(yt), y), (_nhwc(xt.grad), dx),
                      (w.grad.permute(2, 3, 1, 0), dv["params"]["kernel"])):
        assert _ulps(got, want).max() <= 1.0
        assert _equal_share(got, want) >= 0.999
    exact = jnp.asarray(_np(g).sum(axis=(0, 1, 2))).astype(JBF)
    want = dv["params"]["bias"] if sums == "cpu" else exact
    assert np.array_equal(_np(b.grad), _np(want))
    assert sums == "cpu" or not np.array_equal(_np(exact),
                                                _np(dv["params"]["bias"]))


def test_sliced_gru_vjp_matches_flax(cpu_sums):
    """The bf16 ConvGRU (``ConvGRU._sliced``: the conv of h and the conv
    of x with the bias, each rounded, summed in bf16; JAX's sigmoid and
    tanh rules) against flax's ``ConvGRU`` with ``_sliced_conv``, with the
    bias's bf16 sums taken as XLA:CPU takes them (``cpu_sums``): the
    output and the cotangents of h, the context biases and x within 1 ulp,
    at least 99% equal (conv sums in another order; measured 99.9-100%);
    the kernels' and biases' gradients within 1 ulp, 99% equal."""
    rng = np.random.default_rng(3)
    hd, xd = 32, 48
    shp = (1, 8, 12)
    h = np.tanh(rng.normal(size=shp + (hd,)))
    cz, cr, cq = (rng.normal(size=shp + (hd,)) for _ in range(3))
    x = rng.normal(size=shp + (xd,))
    jg = JaxConvGRU(hidden_dim=hd, dtype=JBF)
    v = jg.init(jax.random.key(0), *(jnp.asarray(a).astype(JBF)
                                     for a in (h, cz, cr, cq, x)))
    params = v["params"]
    pg = ConvGRU(hd, xd)
    with torch.no_grad():
        pg.convzr.weight.copy_(torch.from_numpy(np.asarray(
            params["convzr"]["kernel"])).permute(3, 2, 0, 1))
        pg.convzr.bias.copy_(torch.from_numpy(np.asarray(
            params["convzr"]["bias"])))
        pg.convq.weight.copy_(torch.from_numpy(np.asarray(
            params["convq"]["kernel"])).permute(3, 2, 0, 1))
        pg.convq.bias.copy_(torch.from_numpy(np.asarray(
            params["convq"]["bias"])))

    def jfn(p, *a):
        return jg.apply({"params": p}, *a)

    ins = [jnp.asarray(a).astype(JBF) for a in (h, cz, cr, cq, x)]
    y, vjp = jax.vjp(jfn, params, *ins)
    g = jnp.asarray(rng.normal(size=y.shape)).astype(JBF)
    dp, *dins = vjp(g)
    tins = [_nchw(_bf(a)).contiguous().requires_grad_() for a in ins]
    ty = pg(*tins)
    ty.backward(_nchw(_bf(g)))
    pairs = [(_nhwc(ty), y)] + [(_nhwc(t.grad), d)
                                for t, d in zip(tins, dins)]
    for m, name in ((pg.convzr, "convzr"), (pg.convq, "convq")):
        pairs += [(m.weight.grad.permute(2, 3, 1, 0), dp[name]["kernel"]),
                  (m.bias.grad, dp[name]["bias"])]
    for got, want in pairs:
        assert _ulps(got, want).max() <= 1.0
        assert _equal_share(got, want) >= 0.99


@pytest.mark.parametrize("hw,out", [((4, 6), (8, 12)), ((2, 3), (4, 6)),
                                    ((9, 13), (5, 7))],
                         ids=["up", "up_small", "down"])
def test_resize_bf16_vjp_bitwise(hw, out):
    """The bf16 resize (``_resize_bf16``: the row pass half in fp32, JAX's
    ``1 - w`` promoted to fp32) and its VJP: autograd transposes JAX's
    casts (the fp32 cotangent of ``x0 * (1 - w)`` cast to bf16, the bf16
    one of ``x1 * w``) and the gathers' scatter-adds in bf16, giving
    every bit of ``jax.vjp``."""
    x = np.random.default_rng(4).normal(size=(2,) + hw + (8,))
    (y, (jd,)), (ty, (td,)) = _vjp_pair(
        lambda a: jresize(a, out),
        lambda a: resize_bilinear_align_corners(a, out), x)
    assert td.dtype == BF and jd.dtype == JBF
    assert np.array_equal(_np(ty), _np(y))
    assert np.array_equal(_np(td), _np(jd))


@pytest.mark.parametrize("shape", [(1, 16, 24, 64), (2, 6, 10, 96),
                                   (1, 8, 12, 128)],
                         ids=["k2", "k4", "k1"])
def test_instance_norm_bf16_vjp_matches_jax(shape, monkeypatch):
    """The bf16 instance norm (``_InstanceNormBf16``, its k lane groups of
    every k-th column) against ``jax.vjp`` of the JAX package's
    ``InstanceNorm``: with the three bf16 image sums of its transposes
    taken as XLA:CPU takes them, every bit of JAX's cotangent (measured;
    plain autograd through the forward's ops gives 46-58%, up to 4 ulps);
    with the port's fp32 sums, within 3 ulps and at least 55% equal
    (measured 61-71%, up to 2.2 ulps)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=shape) + 0.3
    (y, (jd,)), (ty, (td,)) = _vjp_pair(
        lambda a: JaxInstanceNorm().apply({}, a),
        lambda a: _nhwc(instance_norm_bf16(_nchw(a))), x)
    assert np.array_equal(_np(ty), _np(y))
    assert _ulps(td, jd).max() <= 3.0 and _equal_share(td, jd) >= 0.55
    monkeypatch.setattr(tbf16, "sum32", _sum_seq)
    _, (_, (td,)) = _vjp_pair(
        lambda a: JaxInstanceNorm().apply({}, a),
        lambda a: _nhwc(instance_norm_bf16(_nchw(a))), x)
    assert np.array_equal(_np(td), _np(jd))


# ------------------------------------------------------------ encoders

@pytest.fixture(scope="module")
def tiny_vars():
    """The TINY model's variables, made with numpy from the tree's shapes
    (cheaper than compiling ``init``)."""
    model = JaxModel(JaxConfig(fused_encoder=False, **TINY))
    return _seeded_variables(jax.eval_shape(
        lambda k: model.init(k, image_hw=HW), jax.random.key(0)))


def _port_model(v, **kw):
    port = RAFTStereo(RAFTStereoConfig(**TINY, **kw), device="cpu")
    port.load_state_dict(variables_to_state_dict(v), strict=True)
    return port


def _block_grads(v, enc, jenc, jv, sub, jname, pname, x, seed):
    """One encoder block's VJP in JAX and in the port on the same bf16
    input and cotangent: (dx, param grads) of each, the JAX param grads
    mapped to port names through the weight bridge."""
    def jfn(p, a):
        return jenc.apply(dict(jv, params=p), a,
                          method=lambda m, t: jname(m)(t))

    y, vjp = jax.vjp(jfn, jv["params"], x)
    g = jnp.asarray(np.random.default_rng(seed).normal(size=y.shape)).astype(
        JBF)
    dp, dx = vjp(g)
    tree = jax.tree.map(np.zeros_like, jax.device_get(v["params"]))
    tree[sub] = jax.device_get(dp)
    want = {k: t for k, t in variables_to_state_dict(
        {"params": tree}).items() if k.startswith(f"{sub}.{pname}.")}
    block = enc.get_submodule(pname)
    block.zero_grad()
    xt = _nchw(_bf(x)).contiguous().requires_grad_()
    yt = block(xt)
    yt.backward(_nchw(_bf(g)))
    got = {f"{sub}.{pname}.{k}": p.grad for k, p in block.named_parameters()}
    assert set(got) == set(want)
    return (_nhwc(yt), y), (_nhwc(xt.grad), dx), got, want


# (encoder, the port's block, the JAX block of the same weights, input
# shape NHWC): instance norm at k = 2, 4 and 1 lane groups (fnet), the
# frozen batch norm (cnet), stride-2 projections, a head.
BLOCKS = {
    "fnet_layer1.0": ("fnet", "layer1.0", lambda m: m.layer1_0,
                      (1, 8, 12, 64)),
    "fnet_layer2.0": ("fnet", "layer2.0", lambda m: m.layer2_0,
                      (1, 8, 12, 64)),
    "fnet_layer3.1": ("fnet", "layer3.1", lambda m: m.layer3_1,
                      (1, 4, 6, 128)),
    "cnet_layer1.1": ("cnet", "layer1.1", lambda m: m.layer1_1,
                      (1, 8, 12, 64)),
    "cnet_layer4.0": ("cnet", "layer4.0", lambda m: m.layer4_0,
                      (1, 4, 6, 128)),
    "cnet_outputs08.0.0": ("cnet", "outputs08.0.0",
                           lambda m: m.heads08[0][0], (1, 4, 6, 128)),
}


@pytest.fixture(scope="module")
def bf16_encoders(tiny_vars):
    """The port's bf16 encoders and the JAX ones with their variables."""
    v = tiny_vars
    port = _port_model(v, compute_dtype="bfloat16")
    fnet = JaxBasicEncoder(output_dim=256, norm_fn="instance", downsample=2,
                           dtype=JBF, fused_stem=False)
    cnet = JaxMultiEncoder(output_dims=((32,) * 3,) * 2, norm_fn="batch",
                           downsample=2, dtype=JBF, fused_stem=False)
    return {"fnet": (port.fnet, fnet, {"params": v["params"]["fnet"]}),
            "cnet": (port.cnet, cnet,
                     {"params": v["params"]["cnet"],
                      "batch_stats": v["batch_stats"]["cnet"]})}


@pytest.mark.parametrize("block", list(BLOCKS))
def test_encoder_blocks_bf16_vjp_match_flax(tiny_vars, bf16_encoders, block,
                                            cpu_sums):
    """The plain encoders' bf16 backward, block by block on the same bf16
    input and cotangent, the bf16 image sums taken as XLA:CPU takes them
    (``cpu_sums``): residual blocks with instance norm (fnet) or the
    frozen batch norm (cnet, whose weight and bias take gradients),
    stride-2 projections, a head.  Outputs and input cotangents: at least
    97% bitwise equal, within 3 ulps (conv sums in another order, whose
    flips instance norm spreads over a channel; measured 98.4-100%, up to
    2 ulps).  Parameter gradients within 0.5% of the block's largest
    (products summed over the pixels in another order; measured up to
    0.29%; with the port's own fp32 image sums up to 5%)."""
    sub, pname, jname, shape = BLOCKS[block]
    enc, jenc, jv = bf16_encoders[sub]
    x = jnp.asarray(np.maximum(np.random.default_rng(5).normal(size=shape),
                               0)).astype(JBF)
    (yt, y), (dxt, dx), got, want = _block_grads(
        tiny_vars, enc, jenc, jv, sub, jname, pname, x, seed=1)
    for a, b in ((yt, y), (dxt, dx)):
        assert a.dtype == BF
        assert _ulps(a, b).max() <= 3.0
        assert _equal_share(a, b) >= 0.97
    gmax = max(float(t.abs().max()) for t in want.values())
    for k, t in want.items():
        assert got[k].dtype == torch.float32
        assert float((got[k] - t).abs().max()) <= 0.005 * gmax, k


# --------------------------------------------------------------- model

def _batch():
    rng = np.random.default_rng(0)
    i1, i2 = (rng.uniform(0, 255, (1,) + HW + (3,)).astype(np.float32)
              for _ in range(2))
    gt = -rng.uniform(1, 20, (1,) + HW + (1,)).astype(np.float32)
    valid = (rng.uniform(size=(1,) + HW) > 0.1).astype(np.float32)
    return i1, i2, gt, valid


def _pinned_encoders(v):
    """The JAX bf16 encoders' outputs on the batch's images: cnet's
    (hidden, context) heads per level and fnet's feature maps."""
    jb = JaxModel(JaxConfig(fused_encoder=False, compute_dtype="bfloat16",
                            **TINY))
    i1, i2, _, _ = _batch()

    def norm(img):
        return (2.0 * (jnp.asarray(img) / 255.0) - 1.0).astype(JBF)

    a, b = norm(i1), norm(i2)
    couts = jb.cnet.apply(jb._split_vars(v, "cnet"), a,
                          num_layers=TINY["n_gru_layers"])
    fmaps = jb.fnet.apply(jb._split_vars(v, "fnet"),
                          jnp.concatenate([a, b], 0))
    return couts, fmaps


def _jax_train(v, couts, fmaps, **kw):
    """``jax.grad`` of the JAX model's sequence loss (``pallas_alt`` with
    its custom VJP in interpret mode unless ``kw`` names another backend,
    ``gru_backend="xla"``, jitted) with the encoders' outputs given: the
    loss, every iteration's prediction and the gradients of the
    parameters (also as JAX's tree, ``tree``), of cnet's outputs and of
    fnet's maps."""
    jm = JaxModel(JaxConfig(**{**dict(fused_encoder=False, gru_backend="xla",
                                      corr_implementation="pallas_alt",
                                      **TINY), **kw}))
    dt = jm.dtype
    couts = [[o.astype(dt) for o in lvl] for lvl in couts]
    fmaps = fmaps.astype(dt)
    i1, i2, gt, valid = (jnp.asarray(a) for a in _batch())

    def loss_fn(params, couts, fmaps):
        def encode(variables, img1, img2):
            net = [jnp.tanh(o[0]) for o in couts]
            inp = [jax.nn.relu(o[1]) for o in couts]
            zqr = jm.zqr.apply(jm._split_vars(variables, "zqr"), inp)
            return net, zqr, fmaps[:1], fmaps[1:]

        jm._encode = encode
        preds = jm.forward(dict(v, params=params), i1, i2, iters=ITERS)
        loss, _ = jax_sequence_loss(preds, gt, valid)
        return loss, preds

    (loss, preds), grads = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True))(v["params"], couts, fmaps)
    tree = jax.device_get(grads[0])
    return dict(loss=float(loss), preds=_np(preds), tree=tree,
                params=variables_to_state_dict({"params": tree}),
                couts=[_np(o) for lvl in grads[1] for o in lvl],
                fmaps=_np(grads[2]))


def _port_train(v, couts, fmaps, **kw):
    """The port in bf16 train mode with the same encoder outputs pinned
    as leaf tensors: loss, predictions and the same gradients."""
    port = _port_model(v, compute_dtype="bfloat16", **kw)
    pc = [[_bf(o).requires_grad_() for o in lvl] for lvl in couts]
    pf = _bf(fmaps).requires_grad_()
    port.cnet.forward = lambda x: [[_nchw(o) for o in lvl] for lvl in pc]
    port.fnet.forward = lambda x: _nchw(pf)
    i1, i2, gt, valid = (torch.from_numpy(a) for a in _batch())
    preds = port(i1, i2, iters=ITERS, test_mode=False)
    loss, _ = sequence_loss(preds, gt, valid)
    loss.backward()
    assert preds.dtype == torch.float32
    return dict(loss=float(loss.detach()), preds=_np(preds),
                params={k: p.grad for k, p in port.named_parameters()
                        if p.grad is not None},
                couts=[_np(o.grad) for lvl in pc for o in lvl],
                fmaps=_np(pf.grad))


@pytest.fixture(scope="module")
def jax_runs(tiny_vars):
    """JAX's bf16 training gradients for both correlation dtypes, and
    its fp32 ones on the same pinned encoder outputs (the gap)."""
    couts, fmaps = _pinned_encoders(tiny_vars)
    runs = {cd: _jax_train(tiny_vars, couts, fmaps,
                           compute_dtype="bfloat16", corr_dtype=cd)
            for cd in ("bfloat16", "float32")}
    runs["fp32"] = _jax_train(tiny_vars, couts, fmaps)
    return couts, fmaps, runs


def _ratio(port, want, fp32):
    """|port - JAX bf16| over |JAX fp32 - JAX bf16|, as 2-norms."""
    return (np.linalg.norm(port - want) / np.linalg.norm(fp32 - want))


# The port's distance from JAX's bf16 run, as a share of JAX's own
# bf16-vs-fp32 gap on the same inputs (2-norms), for the predictions, the
# non-encoder parameters' gradients, fnet's and cnet's cotangents:
# measured 0.17-0.20, 0.29-0.37, 0.34-0.42 and 0.43-0.52.  A port that ran
# fp32 would sit at about 1.  The random-weight GRU makes each iteration
# amplify rounding noise, so no element-wise bound is this tight.
GAP_SHARE = 0.7


def _check_train(port, want, fp32):
    assert port["preds"].shape == want["preds"].shape == (ITERS, 1) + HW + (
        1,)
    assert np.isfinite(port["preds"]).all() and np.isfinite(port["loss"])
    assert np.abs(want["preds"]).max() > 5.0  # a non-trivial comparison
    # loss: measured 0.5e-4-2.4e-4 relative; JAX's gap 1.0e-3-1.8e-3
    loss_gap = abs(fp32["loss"] - want["loss"]) / want["loss"]
    assert abs(port["loss"] - want["loss"]) / want["loss"] <= 6e-4 < loss_gap
    # predictions: measured 0.06-0.11 px; JAX's gap 0.36-0.37 px
    pred_gap = np.abs(fp32["preds"] - want["preds"]).max()
    assert np.abs(port["preds"] - want["preds"]).max() <= 0.2 < pred_gap
    names = sorted(k for k in want["params"]
                   if not k.startswith(("fnet.", "cnet.")))
    assert set(names) <= set(port["params"])
    flat = [np.concatenate([_np(d["params"][k]).ravel() for k in names])
            for d in (port, want, fp32)]
    cat = [np.concatenate([o.ravel() for o in d["couts"]])
           for d in (port, want, fp32)]
    for a, w, r in (tuple(d["preds"] for d in (port, want, fp32)), flat,
                    tuple(d["fmaps"] for d in (port, want, fp32)), cat):
        assert _ratio(a, w, r) <= GAP_SHARE


@pytest.mark.parametrize("corr_dtype", ["bfloat16", "float32"])
def test_train_bf16_matches_jax(tiny_vars, jax_runs, corr_dtype):
    """The bf16 model in train mode with ``pallas_alt`` (the lookup's
    backward in its bf16 form for bf16 maps, or the fp32 form for a bf16
    cotangent of fp32 maps), both against ``jax.grad`` of the JAX bf16
    model with the encoders' outputs pinned: the predictions, the loss,
    the gradients of every non-encoder parameter, and the cotangents
    reaching fnet's maps and cnet's outputs, each nearer JAX's bf16 run
    than JAX's fp32 run is (``GAP_SHARE``)."""
    couts, fmaps, runs = jax_runs
    port = _port_train(tiny_vars, couts, fmaps, corr_dtype=corr_dtype)
    _check_train(port, runs[corr_dtype], runs["fp32"])


def test_train_bf16_remat_bitwise(tiny_vars, jax_runs):
    """``remat=True`` in bf16 recomputes each iteration in the backward
    pass and gives every bit of the plain run (and JAX's remat run the
    values of its plain one), so it holds against JAX as that does."""
    couts, fmaps, runs = jax_runs
    plain = _port_train(tiny_vars, couts, fmaps, corr_dtype="bfloat16")
    remat = _port_train(tiny_vars, couts, fmaps, corr_dtype="bfloat16",
                        remat=True)
    assert remat["loss"] == plain["loss"]
    assert np.array_equal(remat["preds"], plain["preds"])
    assert np.array_equal(remat["fmaps"], plain["fmaps"])
    for k, g in plain["params"].items():
        assert torch.equal(remat["params"][k], g), k
    _check_train(remat, runs["bfloat16"], runs["fp32"])


@pytest.mark.parametrize("impl", ["reg", "alt", "pallas"])
def test_train_bf16_other_backends(tiny_vars, jax_runs, impl):
    """``reg``, ``alt`` and ``pallas`` at fp32 correlation in bf16 train
    mode: the fp32 lookup (differentiable through autograd or row 6's
    backward) cast to bf16, the same function as ``pallas_alt`` with fp32
    maps; held against JAX's bf16 run of that function by the same
    rule."""
    couts, fmaps, runs = jax_runs
    port = _port_train(tiny_vars, couts, fmaps, corr_implementation=impl)
    _check_train(port, runs["float32"], runs["fp32"])


def test_one_bf16_step_params_match_jax(tiny_vars, jax_runs):
    """One ``make_train_step`` of the bf16 model against the JAX package's
    train step (``make_train_step``) on its bf16 config, both with the
    encoders' outputs pinned: the loss within the model test's 6e-4, and
    every parameter within 2x the step's learning rate (Adam's first step
    moves each entry by about lr, so a sign flip of a rounding-level
    gradient moves it by at most 2 lr), plus the fp32 rounding of the
    updated parameter.  This holds the JAX package's policy: parameters
    and Adam moments stay fp32, the loss is computed in fp32, and there is
    no loss scaling."""
    v = tiny_vars
    couts, fmaps, _ = jax_runs
    jm = JaxModel(JaxConfig(fused_encoder=False, gru_backend="xla",
                            corr_implementation="pallas_alt",
                            compute_dtype="bfloat16",
                            corr_dtype="bfloat16", **TINY))

    def encode(variables, img1, img2):
        net = [jnp.tanh(o[0]) for o in couts]
        inp = [jax.nn.relu(o[1]) for o in couts]
        zqr = jm.zqr.apply(jm._split_vars(variables, "zqr"), inp)
        return net, zqr, fmaps[:1], fmaps[1:]

    jm._encode = encode
    tcfg = JaxTrainConfig(batch_size=1, image_size=HW, train_iters=ITERS,
                          data_parallel=1)
    tx, schedule = jax_make_optimizer(tcfg)
    jstep = jax.jit(jax_make_step(jm, tx, tcfg, schedule))
    batch = tuple(jnp.asarray(a) for a in _batch())
    jstate, jmetrics = jstep(state_from_variables(v, tx), batch)
    want = variables_to_state_dict(
        {"params": jax.device_get(jstate.params)})

    port = _port_model(v, corr_implementation="pallas_alt",
                       compute_dtype="bfloat16", corr_dtype="bfloat16")
    port.cnet.forward = lambda x: [[_nchw(_bf(o)) for o in lvl]
                                   for lvl in couts]
    port.fnet.forward = lambda x: _nchw(_bf(fmaps))
    cfg = TrainConfig(batch_size=1, image_size=HW, train_iters=ITERS)
    opt, sched = make_optimizer(cfg, dict(port.named_parameters()))
    state = TrainState(step=0, model=port, opt=opt)
    metrics = make_train_step(cfg, sched)(
        state, tuple(torch.from_numpy(a) for a in _batch()))
    lr = float(schedule(0))
    assert metrics["lr"] == lr and state.step == 1 and opt.count == 1
    assert metrics["loss"] == pytest.approx(float(jmetrics["loss"]),
                                            rel=6e-4)
    start, moved = variables_to_state_dict(v), 0
    for k, t in port.named_parameters():
        assert t.dtype == torch.float32
        err = float((t.detach() - want[k]).abs().max())
        ulp = float(want[k].abs().max()) * 2.0 ** -23
        assert err <= 2 * lr + ulp, (k, err, lr)
        moved += float((want[k] - start[k]).abs().max()) > 0.5 * lr
    assert moved > 20  # the non-encoder parameters took a real step


# ----------------------------------------------------------------- CLI

def test_cli_train_mixed_precision(tmp_path, monkeypatch):
    """``cli.train.main --mixed_precision --corr_dtype bfloat16 --device
    cpu`` on a tiny synthetic KITTI tree: two finite steps (``num_steps``
    1 runs steps 0 and 1), the bf16 config passed through."""
    from raftstereo_tpu_torch.data import synthetic as tsyn
    from raftstereo_tpu_torch.train import logger as tlogger

    monkeypatch.setattr(tlogger, "_make_tb_writer", lambda log_dir: None)
    root = tmp_path / "data"
    tsyn.make_learnable_kitti(str(root), n=2, hw=(40, 56))
    seen = {}
    real = cli_train.train

    def spy(model_cfg, cfg, **kw):
        seen["cfg"] = model_cfg
        return real(model_cfg, cfg, **kw)

    monkeypatch.setattr(cli_train, "train", spy)
    monkeypatch.chdir(tmp_path)
    rc = cli_train.main([
        "--name", "bf16", "--train_datasets", "kitti", "--dataset_root",
        str(root), "--batch_size", "1", "--num_steps", "1", "--train_iters",
        "2", "--image_size", "32", "48", "--no_validation", "--num_workers",
        "0", "--device", "cpu", "--n_gru_layers", "2", "--hidden_dims", "16",
        "16", "--corr_levels", "2", "--corr_radius", "2",
        "--mixed_precision", "--corr_dtype", "bfloat16"])
    assert rc == 0
    cfg = seen["cfg"]
    assert (cfg.compute_dtype, cfg.corr_dtype) == ("bfloat16", "bfloat16")
    recs = [json.loads(line) for line in
            (tmp_path / "runs" / "bf16" / "metrics.jsonl").read_text()
            .splitlines()]
    losses = [r["live_loss"] for r in recs if "live_loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_cli_train_flag_defaults():
    """The JAX package's names and defaults: ``--mixed_precision`` off,
    ``--corr_dtype float32``."""
    p = argparse.ArgumentParser()
    cli_train.add_train_args(p)
    cfg = cli_train.model_config_from_args(p.parse_args([]))
    assert (cfg.compute_dtype, cfg.corr_dtype) == ("float32", "float32")
    cfg = cli_train.model_config_from_args(p.parse_args(
        ["--mixed_precision"]))
    assert (cfg.compute_dtype, cfg.corr_dtype) == ("bfloat16", "float32")


def test_cli_profile_train_takes_mixed_precision(monkeypatch):
    """``cli/profile.py --train`` takes ``--mixed_precision`` and
    ``--corr_dtype``; ``--gru_backend`` stays a serving option and
    ``--corr_quant`` an inference one."""
    seen = {}

    def fake_train_call(remat, impl, fused, mixed=False,
                        corr_dtype="float32"):
        seen.update(mixed=mixed, corr_dtype=corr_dtype)
        raise SystemExit(0)

    monkeypatch.setattr(cli_profile, "_train_call", fake_train_call)
    with pytest.raises(SystemExit):
        cli_profile.main(["--train", "--mixed_precision", "--corr_dtype",
                          "bfloat16"])
    assert seen == dict(mixed=True, corr_dtype="bfloat16")
    for bad in (["--gru_backend", "xla"], ["--corr_quant"]):
        with pytest.raises(SystemExit) as e:
            cli_profile.main(["--train", "--mixed_precision"] + bad)
        assert e.value.code == 2
