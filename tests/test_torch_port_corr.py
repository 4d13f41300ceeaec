"""The port's precomputed-volume correlation against the JAX package, CPU.

Covers the ``reg``, ``alt`` and ``pallas`` backends and ``corr_quant``:
the int8 quantization and volume (bitwise), the fp32 volume and its
pyramid, the volume lookup and its backward (the plain versions of
``csrc/corr_vol.cu`` and ``csrc/corr_vol_bwd.cu``), the ``reg``/``alt``
lookups, and the whole model in test mode and one train step.  Inputs
are made with numpy from a seed and passed to both packages; the JAX side
runs its Pallas kernels in interpret mode (automatic off the TPU), as its
own tests do.  Tolerances are stated per test with their reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse

from raftstereo_tpu import RAFTStereoConfig as JaxConfig
from raftstereo_tpu.models import RAFTStereo as JaxModel
from raftstereo_tpu.ops import corr as jcorr
from raftstereo_tpu.ops import pallas_corr as jpc
from raftstereo_tpu.ops import quant as jquant
from raftstereo_tpu.train.loss import sequence_loss as jax_sequence_loss
from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig
from raftstereo_tpu_torch.cli import serve as cli_serve
from raftstereo_tpu_torch.cli import train as cli_train
from raftstereo_tpu_torch.ops import cuda_vol, quant
from raftstereo_tpu_torch.ops.corr import (build_corr_pyramid,
                                           build_corr_state,
                                           build_corr_volume, corr_lookup,
                                           resolve_implementation)
from raftstereo_tpu_torch.ops.sampler import linear_sample_1d
from raftstereo_tpu_torch.train.loss import sequence_loss
from raftstereo_tpu_torch.utils.convert import variables_to_state_dict

TINY = dict(n_gru_layers=3, hidden_dims=(32, 32, 32), corr_levels=2,
            corr_radius=2)
HW = (32, 48)
ITERS = 3
# |corr| ~ 1 (dots of 256 unit normals / 16); fp32 reassociation only.
FP32_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _features(rng, b, h, w, c=256):
    return (rng.normal(size=(b, h, w, c)).astype(np.float32),
            rng.normal(size=(b, h, w, c)).astype(np.float32))


def _coords(rng, b, h, w, nan=True):
    """Level-0 x-coordinates with taps past both edges and, optionally,
    NaN pixels."""
    x = (np.arange(w, dtype=np.float32)
         + rng.uniform(-w / 2, 6, (b, h, w)).astype(np.float32))
    x[0, 0, :3] = [-200.5, w + 200.25, 1e6]
    x[0, 1, :2] = [-3.5, w + 1.75]   # partly past each edge
    if nan:
        x[-1, -1, -1] = np.nan
        x[0, h // 2, 1] = np.nan
    return x


# ------------------------------------------------------------ int8 volume

def test_quantize_rows_bitwise():
    """Scales and codes equal the JAX package's, including an all-zero
    row (scale 1.0) and values at half-steps (round half to even)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 2, 3] = np.arange(16, dtype=np.float32) - 7.5
    x[1, 2, 3, 0] = 127.0  # scale 1: codes at .5 steps round to even
    qj, sj = jquant.quantize_rows(jnp.asarray(x))
    q, s = quant.quantize_rows(_t(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    assert s[0, 0, 0] == 1.0 and (q[0, 0, 0] == 0).all()


def _quantized(c, w1=7, w2=9):
    rng = np.random.default_rng(c)
    f1 = rng.normal(size=(2, 3, w1, c)).astype(np.float32)
    f2 = rng.normal(size=(2, 3, w2, c)).astype(np.float32) * 3
    f2[1, 1, 2] = 0.0  # a zero row: scale 1, codes 0
    return [np.array(a) for a in (*jquant.quantize_rows(jnp.asarray(f1)),
                                  *jquant.quantize_rows(jnp.asarray(f2)))]


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("c", [16, 256])
def test_int8_volume_plain_bitwise(ref, c):
    """The plain version against ``_int8_volume_xla`` and against the
    Pallas kernel in interpret mode: exact integer sums and the same
    multiplies in the same association, so every bit is equal."""
    q1, s1, q2, s2 = _quantized(c)
    args = [jnp.asarray(a) for a in (q1, s1, q2, s2)]
    want = np.asarray(jquant._int8_volume_xla(*args) if ref == "xla"
                      else jquant.pallas_int8_corr_volume(*args))
    got = quant.int8_corr_volume(torch.from_numpy(q1), torch.from_numpy(s1),
                                 torch.from_numpy(q2), torch.from_numpy(s2))
    assert got.shape == (2, 3, 7, 9) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[1, 1, :, 2] == 0).all()


def test_int8_plain_product_does_not_wrap():
    """int8 matmul on the CPU returns int8 and wraps; the plain version
    casts first, so a row of 127s gives 127^2 * C."""
    q = torch.full((1, 1, 2, 256), 127, dtype=torch.int8)
    s = torch.ones((1, 1, 2))
    got = quant.int8_volume_plain(q, s, q, s)
    assert float(got[0, 0, 0, 0]) == 127.0 ** 2 * 256 / 16


def test_quant_corr_volume_matches_jax():
    """The whole int8 volume from fp32 features, quantization included,
    against ``quant_corr_volume``'s XLA path: bitwise."""
    f1, f2 = _features(np.random.default_rng(1), 1, 4, 11)
    want = np.asarray(jquant.quant_corr_volume(jnp.asarray(f1),
                                               jnp.asarray(f2), kernel=False))
    got = quant.quant_corr_volume(_t(f1), _t(f2)).numpy()
    np.testing.assert_array_equal(got, want)


def test_int8_wrapper_validates_before_launch():
    q1, s1, q2, s2 = (torch.from_numpy(a) for a in _quantized(16))
    with pytest.raises(ValueError):  # one operand off the CPU, not on CUDA
        quant.int8_corr_volume(q1.to("meta"), s1, q2, s2)


# ------------------------------------------------------ volume + pyramid

@pytest.mark.parametrize("w", [20, 21])
def test_volume_and_pyramid_match_jax(w):
    """The volume within 1e-6 of its largest entry (fp32 dots of length
    256 summed in another order), then the pyramid from the same volume
    within 1e-6 (means of two: the same arithmetic)."""
    f1, f2 = _features(np.random.default_rng(w), 2, 3, w)
    jv = jcorr.build_corr_volume(jnp.asarray(f1), jnp.asarray(f2))
    v = build_corr_volume(_t(f1), _t(f2))
    scale = float(np.abs(np.asarray(jv)).max())
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-6 * scale)
    want = jcorr.build_corr_pyramid(jv, 4)
    got = build_corr_pyramid(_t(np.asarray(jv)), 4)
    assert [g.shape[-1] for g in got] == [p.shape[-1] for p in want]
    for g, p in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(p), rtol=0,
                                   atol=1e-6)


def test_pallas_state_is_the_real_width_concat():
    """No lane, W1 or row pad: the ``pallas`` state is the pyramid
    concatenated along W2 at its real widths."""
    f1, f2 = _features(np.random.default_rng(2), 1, 3, 21, c=16)
    st = build_corr_state(_t(f1), _t(f2), 4, "pallas")
    assert st.backend == "pallas" and st.widths == (21, 10, 5, 2)
    assert st.vcat.shape == (1, 3, 21, 38) and st.fmap1 is None
    pyr = build_corr_pyramid(build_corr_volume(_t(f1), _t(f2)), 4)
    assert torch.equal(st.vcat, torch.cat(pyr, dim=-1))


def test_resolve_implementation_follows_the_accelerator_rule():
    assert resolve_implementation("auto") == "pallas_alt"
    for impl in ("reg", "alt", "pallas", "pallas_alt"):
        assert resolve_implementation(impl) == impl
        assert resolve_implementation(impl, quant=True) == "pallas"
    with pytest.raises(ValueError):
        resolve_implementation("cuda")


# ---------------------------------------------------------------- lookup

def _jax_lookup(backend, f1, f2, x, levels, radius):
    fn = jcorr.make_corr_fn(backend, jnp.asarray(f1), jnp.asarray(f2),
                            levels, radius)
    return np.asarray(fn(jnp.asarray(x)[..., None]))


@pytest.mark.parametrize("port,ref", [
    ("pallas", "pallas"), ("pallas", "reg"), ("reg", "reg"), ("alt", "alt"),
    ("reg", "pallas"), ("alt", "reg")])
def test_lookup_plain_matches_jax(port, ref):
    """Row 5's plain version (``pallas``) and the ``reg``/``alt`` lookups
    against the JAX package's ``pallas`` backend (interpret mode) and its
    XLA lookups: odd H, 4 levels down to width 2, taps past both edges and
    NaN coordinates (NaN out, finite elsewhere)."""
    rng = np.random.default_rng(3)
    b, h, w = 2, 7, 20
    f1, f2 = _features(rng, b, h, w)
    x = _coords(rng, b, h, w)
    want = _jax_lookup(ref, f1, f2, x, 4, 4)
    got = corr_lookup(build_corr_state(_t(f1), _t(f2), 4, port), _t(x),
                      4).numpy()
    assert got.shape == want.shape == x.shape + (36,)
    nan_pix = np.isnan(x)
    assert np.isnan(got[nan_pix]).all() and np.isnan(want[nan_pix]).all()
    assert np.isfinite(got[~nan_pix]).all()
    np.testing.assert_allclose(got, want, **FP32_TOL)
    assert (got[0, 0, 0] == 0).all() and (got[0, 0, 2] == 0).all()
    assert (got[0, 1, 0] != 0).any()  # partly past the edge: some taps in


def test_linear_sample_1d_matches_jax():
    from raftstereo_tpu.ops.sampler import linear_sample_1d as jls

    rng = np.random.default_rng(4)
    vol = rng.normal(size=(3, 5, 9)).astype(np.float32)
    x = rng.uniform(-2, 10, (3, 5, 4)).astype(np.float32)
    x[0, 0] = [np.nan, -1.0, 8.0, 8.5]
    want = np.asarray(jls(jnp.asarray(vol), jnp.asarray(x)))
    got = linear_sample_1d(_t(vol), _t(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **FP32_TOL)


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
def test_vol_lookup_backward_plain_matches_jax(nan):
    """Row 6: the plain VJP to one volume level against ``jax.vjp`` of
    ``pallas_lookup`` (the Pallas lookup's custom VJP, interpret mode).
    A NaN coordinate poisons the pixel's whole level row, in both."""
    rng = np.random.default_rng(5)
    b, h, w, r = 2, 3, 13, 4
    vol = rng.normal(size=(b, h, w, w)).astype(np.float32)
    x = _coords(rng, b, h, w, nan=nan)
    taps = x[..., None] + np.arange(-r, r + 1, dtype=np.float32)
    g = rng.normal(size=(b, h, w, 2 * r + 1)).astype(np.float32)
    _, vjp = jax.vjp(jpc.pallas_lookup, jnp.asarray(vol), jnp.asarray(taps))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = cuda_vol.vol_lookup_backward(_t(x), _t(g), (w,), r).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any() == nan
    if nan:
        assert np.isnan(got[-1, -1, -1]).all()
    # sums of 9 products of O(1) terms: a few ulps.
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               rtol=0, atol=1e-5)


def _vjp_jax(backend, f1, f2, x, g, levels, radius):
    def lookup(a, b):
        fn = jcorr.make_corr_fn(backend, a, b, levels, radius)
        return fn(jnp.asarray(x)[..., None])

    vjp = jax.vjp(lookup, jnp.asarray(f1), jnp.asarray(f2))[1]
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("backend,nan", [
    ("pallas", False), ("pallas", True), ("reg", False), ("alt", False)],
    ids=["pallas", "pallas-nan", "reg", "alt"])
def test_lookup_gradients_match_jax(backend, nan):
    """Gradients to fmap1 and fmap2 through each backend's lookup (the
    ``pallas`` one through row 6's plain version, the volume product and
    the pyramid) against ``jax.vjp`` of the same backend.  With a NaN
    coordinate the Pallas VJP poisons the pixel's level rows, so NaN
    reaches every channel of the image row's fmap1 and fmap2 in both.
    ``reg``/``alt``'s gather VJPs poison only gathered columns, so they
    run without NaN."""
    rng = np.random.default_rng(6)
    b, h, w, levels, r = 2, 3, 12, 3, 3
    f1, f2 = _features(rng, b, h, w, c=64)
    x = _coords(rng, b, h, w, nan=nan)
    g = rng.normal(size=(b, h, w, levels * (2 * r + 1))).astype(np.float32)
    want = _vjp_jax(backend, f1, f2, x, g, levels, r)
    t1, t2 = _t(f1).requires_grad_(), _t(f2).requires_grad_()
    out = corr_lookup(build_corr_state(t1, t2, levels, backend), _t(x), r)
    out.backward(_t(g))
    for gt, wt in zip((t1.grad.numpy(), t2.grad.numpy()), want):
        np.testing.assert_array_equal(np.isnan(gt), np.isnan(wt))
        assert np.isnan(gt).any() == nan
        # dots of ~40 O(1) products, then the volume's transposed
        # product over w: reordered fp32 sums.
        np.testing.assert_allclose(np.nan_to_num(gt), np.nan_to_num(wt),
                                   rtol=0, atol=2e-5)


def test_vol_wrappers_validate_before_launch():
    rng = np.random.default_rng(7)
    vcat = _t(rng.normal(size=(1, 2, 8, 12)))
    x = _t(np.zeros((1, 2, 8)))
    with pytest.raises(ValueError):
        cuda_vol.vol_lookup(vcat.to("meta"), (8, 4), x, 2)
    with pytest.raises(ValueError):
        cuda_vol.vol_lookup_backward(x, torch.zeros((1, 2, 8, 10),
                                                    device="meta"), (8, 4), 2)


# ------------------------------------------------------------ the model

def _jax_init(cfg):
    model = JaxModel(cfg)
    v = jax.jit(lambda k: model.init(k, image_hw=HW))(jax.random.key(0))
    return model, jax.device_get(v)


@pytest.fixture(scope="module")
def weights():
    _, v = _jax_init(JaxConfig(fused_encoder=False, **TINY))
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(0, 255, (1,) + HW + (3,)).astype(np.float32)
            for _ in range(2)]
    return v, imgs


_BACKENDS = {"reg": dict(corr_implementation="reg"),
             "alt": dict(corr_implementation="alt"),
             "pallas": dict(corr_implementation="pallas"),
             "corr_quant": dict(corr_quant=True)}


# Thresholds of tests/test_torch_port_model.py (2e-3 low-res, 5e-3
# full-res): fp32 rounding differences between two frameworks, carried
# through three GRU iterations (disparities here are O(30) px).
@pytest.mark.parametrize("gru", ["fused", "xla"])
@pytest.mark.parametrize("backend", list(_BACKENDS))
def test_forward_matches_jax(weights, backend, gru):
    """Test mode of each backend and GRU step against the JAX model on
    the same weights (JAX jitted; its ``pallas`` lookup and ``fused`` GRU
    in interpret mode).  ``corr_quant`` runs JAX's int8 volume with its
    CPU lookup (``reg``) and the port's with ``pallas``: the same
    function."""
    v, imgs = weights
    kw = dict(_BACKENDS[backend], gru_backend=gru, **TINY)
    jmodel = JaxModel(JaxConfig(fused_encoder=False, **kw))
    lo, up = jax.jit(lambda v, a, b: jmodel.forward(
        v, a, b, iters=ITERS, test_mode=True))(
            v, *(jnp.asarray(i) for i in imgs))
    port = RAFTStereo(RAFTStereoConfig(**kw), device="cpu")
    port.load_state_dict(variables_to_state_dict(v), strict=True)
    plo, pup = port(*(torch.from_numpy(i) for i in imgs), iters=ITERS)
    assert plo.shape == (1, 8, 12, 1) and pup.shape == (1,) + HW + (1,)
    assert np.abs(np.asarray(lo)).max() > 1.0  # a non-trivial comparison
    np.testing.assert_allclose(plo.numpy(), np.asarray(lo), rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(pup.numpy(), np.asarray(up), rtol=0,
                               atol=5e-3)


def _train_case(port, batch):
    preds = port(*batch[:2], iters=ITERS, test_mode=False)
    loss, _ = sequence_loss(preds, *batch[2:])
    loss.backward()
    return (float(loss.detach()), preds.detach(),
            {k: p.grad.clone() for k, p in port.named_parameters()})


def _batch():
    rng = np.random.default_rng(1)
    i1, i2 = (rng.uniform(0, 255, (1,) + HW + (3,)).astype(np.float32)
              for _ in range(2))
    gt = -rng.uniform(1, 20, (1,) + HW + (1,)).astype(np.float32)
    valid = (rng.uniform(size=(1,) + HW) > 0.1).astype(np.float32)
    return i1, i2, gt, valid


def test_pallas_train_step_matches_jax(weights):
    """A ``pallas`` train-mode forward, loss and every gradient against
    JAX's jitted ``value_and_grad`` through its Pallas lookup and custom
    VJP (interpret mode): loss within 1e-5 relative, gradients within
    1e-3 of the largest JAX entry (fp32 reductions over ~10^4 terms,
    reordered, through three iterations)."""
    v, _ = weights
    jmodel = JaxModel(JaxConfig(corr_implementation="pallas",
                                gru_backend="xla", fused_encoder=False,
                                **TINY))
    i1, i2, gt, valid = _batch()

    def loss_fn(params):
        preds = jmodel.forward(dict(v, params=params), jnp.asarray(i1),
                               jnp.asarray(i2), iters=ITERS)
        return jax_sequence_loss(preds, jnp.asarray(gt),
                                 jnp.asarray(valid))[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    port = RAFTStereo(RAFTStereoConfig(corr_implementation="pallas", **TINY),
                      device="cpu")
    port.load_state_dict(variables_to_state_dict(v), strict=True)
    loss, _, grads = _train_case(port, [torch.from_numpy(a)
                                        for a in (i1, i2, gt, valid)])
    assert loss == pytest.approx(float(jloss), rel=1e-5)
    gj = variables_to_state_dict({"params": jax.device_get(jgrads)})
    assert set(gj) == set(grads)
    gmax = max(float(t.abs().max()) for t in gj.values())
    bad = {k: float((grads[k] - gj[k]).abs().max()) for k in gj}
    bad = {k: e for k, e in bad.items() if e > 1e-3 * gmax}
    assert not bad, (gmax, bad)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_train_mode_ignores_corr_quant(weights, backend):
    """Train mode builds the unquantized volume whatever ``corr_quant``
    says: predictions, loss and gradients bitwise equal."""
    v, _ = weights
    batch = [torch.from_numpy(a) for a in _batch()]
    out = []
    for q in (False, True):
        port = RAFTStereo(RAFTStereoConfig(corr_implementation=backend,
                                           corr_quant=q, **TINY),
                          device="cpu")
        port.load_state_dict(variables_to_state_dict(v), strict=True)
        out.append(_train_case(port, batch))
    (la, pa, ga), (lb, pb, gb) = out
    assert la == lb and torch.equal(pa, pb)
    assert all(torch.equal(ga[k], gb[k]) for k in ga)


# ------------------------------------------------------- entry points

def test_serve_cli_takes_the_corr_flags():
    args = cli_serve.parse_args(["--corr_implementation", "pallas",
                                 "--corr_quant", "--gru_backend", "xla"])
    assert (args.corr_implementation, args.corr_quant,
            args.gru_backend) == ("pallas", True, "xla")
    default = cli_serve.parse_args([])
    assert (default.corr_implementation, default.corr_quant,
            default.gru_backend) == ("auto", False, "auto")
    with pytest.raises(SystemExit):
        cli_serve.parse_args(["--corr_implementation", "cuda"])


def test_train_cli_takes_the_corr_flags():
    p = cli_train.argparse.ArgumentParser()
    cli_train.add_train_args(p)
    cfg = cli_train.model_config_from_args(p.parse_args(
        ["--corr_implementation", "reg", "--corr_quant"]))
    assert cfg.corr_implementation == "reg" and cfg.corr_quant is True
    cfg = cli_train.model_config_from_args(p.parse_args([]))
    assert cfg.corr_implementation == "auto" and cfg.corr_quant is False
