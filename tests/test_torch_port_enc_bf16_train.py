"""bf16 training of the fused encoder (``fused_encoder=True`` with
``compute_dtype="bfloat16"``), and of the bf16 ``pallas`` volume, against
the JAX package on the CPU.

The JAX side runs its fused stages' custom VJPs at ``dt=bfloat16`` with
the instance-norm backward's dual sums forced through its Pallas kernel
(``pallas_encoder._bwd_packed_sums = True``, interpret mode), so row 14
itself runs on bf16 operands.  Its bf16 functions are compiled with XLA's
excess precision off (``_exact``): a plain jitted bf16 function fuses
across the rounding points, where op-by-op execution rounds after every
operation, and with the flag off the compiled function gives the
op-by-op bits (measured on every stage here: the same bits but for fp32
sums taken in another order) in a third of the time.  The bf16 image sums
of the transposes (a bias's and a frozen affine's cotangent) are taken as
XLA:CPU takes them (``cpu_sums``: one add at a time, each rounded), where
the port, as XLA on an accelerator, sums in fp32 and rounds once.  The
port runs its kernels' plain versions.  Inputs are made with numpy from
a seed.  One bf16 ulp of a value v is 2^-7 * max(1, |v|).

From the bottom up: row 14's bf16 plain version against the TPU kernel;
each fused stage's bf16 VJP; the whole fused encoders' VJPs on both conv1
routes; the TINY model in bf16 train mode with the fused encoder (and on
the bf16 ``pallas`` volume) against ``jax.grad`` of the JAX bf16 model,
its encoders' outputs pinned with their gradients flowing through; one
optimizer step; the CLI.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_bf16_train import (GAP_SHARE, HW, ITERS, TINY, _batch,
                                        _check_train, _equal_share,
                                        _jax_train, _np, _port_model, _ratio,
                                        _ulps, cpu_sums)  # noqa: F401
from test_torch_port_cuda import _Pin
from test_torch_port_encoder import (_affines, _conv, _convs,
                                     _layer2_params, _port_encoder)
from test_torch_port_encoder_train import (_seeded_variables,  # noqa: F401
                                           few_threads, packed_sums)

from raftstereo_tpu import RAFTStereoConfig as JaxConfig
from raftstereo_tpu.config import TrainConfig as JaxTrainConfig
from raftstereo_tpu.models import RAFTStereo as JaxModel
from raftstereo_tpu.models import encoders as jenc
from raftstereo_tpu.ops import pallas_encoder as pe
from raftstereo_tpu.ops import pallas_layer2 as pl2
from raftstereo_tpu.train.optim import make_optimizer as jax_make_optimizer
from raftstereo_tpu_torch import RAFTStereoConfig
from raftstereo_tpu_torch.cli import profile as cli_profile
from raftstereo_tpu_torch.cli import train as cli_train
from raftstereo_tpu_torch.config import TrainConfig
from raftstereo_tpu_torch.data.synthetic import ShiftStereoDataset
from raftstereo_tpu_torch.models import encoders as tenc
from raftstereo_tpu_torch.ops import cuda_encoder as ce
from raftstereo_tpu_torch.ops import encoder_stage as es
from raftstereo_tpu_torch.train import logger as tlogger
from raftstereo_tpu_torch.train.loss import sequence_loss
from raftstereo_tpu_torch.train.optim import make_optimizer
from raftstereo_tpu_torch.train.state import TrainState
from raftstereo_tpu_torch.train import step as tstep
from raftstereo_tpu_torch.train.step import make_train_step
from raftstereo_tpu_torch.utils.convert import (state_dict_to_variables,
                                                variables_to_state_dict)

BF = torch.bfloat16
JBF = jnp.bfloat16
B, H, W, C = 2, 16, 24, 8
CO = 12  # layer2's width at these sizes
STAGE = ("c10", "c11", "c20", "c21")
LAYER2 = ("c1", "c2", "c3", "c4", "proj")
# chip_smoke.py's DUAL_TOL: per-pixel means of fp32 sums in another order.
DUAL_TOL = 1e-5


def _nchw(a) -> torch.Tensor:
    """NHWC (JAX) -> contiguous NCHW torch, in bf16 for a bf16 array."""
    t = torch.from_numpy(np.ascontiguousarray(_np(a).transpose(0, 3, 1, 2)))
    return t.to(BF) if a.dtype == JBF else t


def _nhwc(t) -> np.ndarray:
    return _np(t).transpose(0, 2, 3, 1)


def _bf(rng, shape, scale=1.0, shift=0.0):
    """A seeded bf16 JAX array."""
    return jnp.asarray((rng.normal(size=shape) * scale + shift)
                       .astype(np.float32)).astype(JBF)


def _exact(fn, *args):
    """``fn(*args)`` compiled with XLA's excess precision off, so that each
    bf16 operation rounds as it does op by op."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _cotangent(rng, like):
    """A seeded bf16 cotangent of the structure and shapes of ``like``."""
    return jax.tree.map(lambda o: jnp.asarray(rng.normal(size=o.shape))
                        .astype(JBF), like)


def _vjp_exact(fn, args, rng):
    """(output, cotangent, ``jax.vjp`` of ``fn`` at ``args`` for it), one
    ``_exact`` compilation; the cotangent is seeded bf16."""
    g = _cotangent(rng, jax.eval_shape(fn, *args))
    y, grads = _exact(lambda a, c: (lambda o: (o[0], o[1](c)))(
        jax.vjp(fn, *a)), tuple(args), g)
    return y, g, grads


# ----------------------------------------------------- row 14 in bf16

@pytest.mark.parametrize("shape", [(2, 16, 24, 8), (1, 6, 10, 13),
                                   (3, 4, 6, 5)], ids=["c8", "c13", "c5"])
def test_dual_sums_bf16_plain_matches_jax_kernel(shape):
    """Row 14's plain version on bf16 operands against the TPU kernel
    (``_dual_sum_kernel`` in interpret mode, reached through
    ``_in_bwd_means``, which upcasts u and v in registers): fp32 sums of
    the exact products, as means within ``DUAL_TOL`` of max(1, |JAX|).
    The same sums taken in bf16 (the products rounded, the adds rounded)
    miss that bound."""
    rng = np.random.default_rng(shape[3])
    u = _bf(rng, shape)
    v = _bf(rng, shape, 2.0, 0.5)
    m1, m2 = pe._in_bwd_means(u, v)
    tu, tv = _nchw(u), _nchw(v)
    s1, s2 = ce.dual_sums(tu, tv)
    n = shape[1] * shape[2]
    naive = (tu * tv).sum((2, 3)).float() / n
    for got, want in ((s1, m1), (s2, m2)):
        want = np.asarray(want)[:, 0, 0]
        assert got.dtype == torch.float32 and got.shape == (shape[0],
                                                            shape[3])
        err = np.abs(got.numpy() / n - want).max()
        assert err <= DUAL_TOL * max(1.0, np.abs(want).max())
    assert (np.abs(naive.numpy() - np.asarray(m2)[:, 0, 0]).max()
            > DUAL_TOL * max(1.0, np.abs(np.asarray(m2)).max()))


# ------------------------------------------------------ the stages' VJPs

def _leaf(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_()


def _port_params(tree, names):
    """JAX {name: {kernel, bias}} -> port {name: (OIHW weight, bias)}."""
    return {n: (_leaf(np.asarray(tree[n]["kernel"]).transpose(3, 2, 0, 1)),
                _leaf(tree[n]["bias"])) for n in names}


def _stage_inputs(name, rng):
    """One entry point's bf16 input, conv1 params, stage params and
    affines (JAX trees), stride."""
    stride = 2 if name.endswith("s2") else 1
    c1 = affines = None
    if "conv1" in name:
        x = _bf(rng, (B, H, W, 3))
        c1, _ = _conv(rng, 7, 3, C)
        params, _ = _convs(rng, STAGE, 3, C, C)
    elif name.startswith("layer2"):
        x = jnp.abs(_bf(rng, (B, H, W, C)))
        params, _ = _layer2_params(rng, C, CO)
    else:  # conv1's raw output
        x = _bf(rng, (B, H, W, C), 2.0, 0.3)
        params, _ = _convs(rng, STAGE, 3, C, C)
    if "bn" in name:
        affines, _ = _affines(rng, CO if name.startswith("layer2") else C)
    return x, c1, params, affines, stride


def _jax_stage(name, stride):
    if name.startswith("conv1"):
        return lambda x, c1, p: pe.conv1_stem_layer1(x, c1, p, JBF, stride)
    if name.startswith("bn_conv1"):
        return lambda x, c1, p, a: pe.bn_conv1_stem_layer1(x, c1, p, a, JBF,
                                                           stride)
    return {"stem": pe.stem_layer1, "bn_stem": pe.bn_stem_layer1,
            "layer2": lambda x, p: pl2.fused_layer2(x, p, JBF),
            "layer2_bn": lambda x, p, a: pl2.fused_layer2_bn(x, p, a, JBF)
            }[name]


def _port_stage(name, stride, x, c1, params, affines):
    if name.startswith("conv1"):
        return es.conv1_stem_layer1(x, c1, params, stride)
    if name.startswith("bn_conv1"):
        return es.bn_conv1_stem_layer1(x, c1, params, affines, stride)
    if name == "stem":
        return es.stem_layer1(x, params)
    if name == "bn_stem":
        return es.bn_stem_layer1(x, params, affines)
    if name == "layer2":
        return es.fused_layer2(x, params)
    return es.fused_layer2_bn(x, params, affines)


# The bf16 activations' cotangents: the same rounding points as JAX's,
# so equal where the inputs of each rounding are; a conv transpose's fp32
# sums in another order round to the other bf16 neighbour at a boundary,
# and through the chain after it such a flip moves its neighbours
# (measured: every element equal in six of seven stages, 99.5% of
# conv1_s2's c20 kernel gradient).  The fp32 gradients that are sums over
# the image (biases, affines) are equal but for the order of those sums
# and such flips: held to the stage's largest gradient entry, as
# test_torch_port_encoder_train holds the fp32 stages (a bias ahead of an
# instance norm has an analytic gradient of 0, so its own scale is
# rounding noise).
STAGE_ULPS, STAGE_EQUAL, SUM_TOL = 1.0, 0.99, 1e-4


@pytest.mark.parametrize("name", [
    "conv1_s1", "conv1_s2", "stem", "bn_stem", "bn_conv1_s1", "layer2",
    "layer2_bn"])
def test_stage_bf16_vjp_matches_jax(name, cpu_sums):
    """Each fused stage's bf16 backward against ``jax.vjp`` of its JAX
    counterpart on the same bf16 input and cotangent: the input's
    cotangent (bf16) and each conv kernel's gradient (rounded to bf16,
    then fp32) within ``STAGE_ULPS`` with ``STAGE_EQUAL`` of the elements
    equal; the biases' and frozen affines' gradients (fp32 sums) within
    ``SUM_TOL`` of the stage's largest gradient entry."""
    x, c1, params, affines, stride = _stage_inputs(
        name, np.random.default_rng(7))
    args = [a for a in (x, c1, params, affines) if a is not None]
    y, g, want = _vjp_exact(_jax_stage(name, stride), args,
                            np.random.default_rng(1))
    names = LAYER2 if name.startswith("layer2") else STAGE
    tx = _nchw(x).requires_grad_()
    tp = _port_params(params, names)
    tc1 = _port_params({"c1": c1}, ("c1",))["c1"] if c1 else None
    ta = [(_leaf(s), _leaf(t)) for s, t in affines] if affines else None
    out = _port_stage(name, stride, tx, tc1, tp, ta)
    assert out.dtype == BF and np.array_equal(_nhwc(out), _np(y))
    out.backward(_nchw(g))
    assert tx.grad.dtype == BF
    bf16_pairs = [(_nhwc(tx.grad), want[0])]
    sums = []
    dp = want[2] if c1 else want[1]
    convs = [(tp[n], dp[n]) for n in names]
    if c1:
        convs.append((tc1, want[1]))
    for (w, b), d in convs:
        assert w.grad.dtype == b.grad.dtype == torch.float32
        bf16_pairs.append((w.grad.permute(2, 3, 1, 0), d["kernel"]))
        sums.append((b.grad, d["bias"]))
    if ta:
        sums += [(t.grad, d) for pair, dpair in zip(ta, want[-1])
                 for t, d in zip(pair, dpair)]
    for got, w in bf16_pairs:
        assert (_ulps(got, w).max() <= STAGE_ULPS
                and _equal_share(got, w) >= STAGE_EQUAL)
    scale = max(float(np.abs(_np(w)).max()) for _, w in bf16_pairs[1:] + sums)
    for got, w in sums:
        assert float(np.abs(_np(got) - _np(w)).max()) <= SUM_TOL * scale


# ---------------------------------------------------- the whole encoders

@pytest.fixture(scope="module")
def fused_vars():
    """The TINY model's variables, made with numpy from the tree's
    shapes."""
    model = JaxModel(JaxConfig(fused_encoder=True, **TINY))
    return _seeded_variables(jax.eval_shape(
        lambda k: model.init(k, image_hw=HW), jax.random.key(0)))


def _jax_encoder(kind, dtype):
    if kind == "fnet":
        return jenc.BasicEncoder(output_dim=256, norm_fn="instance",
                                 downsample=2, dtype=dtype, fused_stem=True)
    return jenc.MultiBasicEncoder(output_dims=(TINY["hidden_dims"],) * 2,
                                  norm_fn="batch", downsample=2, dtype=dtype,
                                  fused_stem=True)


def _jax_apply(v, kind, dtype):
    """The JAX encoder ``kind`` as a function of its parameters and
    image, its batch statistics (cnet's) fixed."""
    jm = _jax_encoder(kind, dtype)
    rest = {k: c[kind] for k, c in v.items() if k != "params" and kind in c}
    return lambda p, a: jm.apply(dict(rest, params=p), a)


_VJPS = {}


def _jax_encoder_vjp(v, kind, dtype, x, cot):
    """The JAX encoder's output and ``jax.vjp`` with respect to its
    parameters and image for the cotangent ``cot`` (its output's
    structure), compiled once per encoder, dtype and image shape."""
    key = (kind, jnp.dtype(dtype).name, x.shape)
    if key not in _VJPS:
        f = _jax_apply(v, kind, dtype)
        _VJPS[key] = jax.jit(lambda p, a, g: (lambda o: (o[0], o[1](g)))(
            jax.vjp(f, p, a))).lower(v["params"][kind], x, cot).compile(
                compiler_options={"xla_allow_excess_precision": False})
    return _VJPS[key](v["params"][kind], x, cot)


def _encoder_grads_sd(kind, dp):
    """JAX parameter gradients of one encoder -> the port's names."""
    return {k: t for k, t in variables_to_state_dict(
        {"params": {kind: jax.device_get(dp)}}).items()}


def _port_encoder_vjp(v, kind, x, cot):
    """The port's fused encoder ``kind`` with ``v``'s weights, its
    backward for the image ``x`` and output cotangent ``cot`` (JAX NHWC
    arrays, in their dtype): the image's cotangent (NHWC) and every
    parameter's gradient by name."""
    if kind == "fnet":
        port = _port_encoder(tenc.BasicEncoder, "fnet", v, output_dim=256,
                             norm_fn="instance", downsample=2,
                             fused_stem=True)
    else:
        port = _port_encoder(tenc.MultiBasicEncoder, "cnet", v,
                             output_dims=(TINY["hidden_dims"],) * 2,
                             norm_fn="batch", downsample=2, num_layers=3,
                             fused_stem=True)
    tx = _nchw(x).requires_grad_()
    out = port(tx)
    outs = [out] if kind == "fnet" else [o for lvl in out for o in lvl]
    cots = jax.tree.leaves(cot)
    assert len(outs) == len(cots)
    torch.autograd.backward(outs, [_nchw(c) for c in cots])
    assert tx.grad.dtype == outs[0].dtype == (BF if x.dtype == JBF
                                               else torch.float32)
    return _nhwc(tx.grad), {f"{kind}.{k}": p.grad
                            for k, p in port.named_parameters()}


# The whole encoders chain the stages with the plain bf16 modules after
# them (layer3, cnet's heads), whose backward rounds as JAX's does
# (test_torch_port_bf16_train's blocks).  A conv output that rounds to
# the other neighbour in the forward (the fused trunk's outputs are 53-97%
# equal to JAX's here, as test_torch_port_enc_bf16 finds) moves the
# backward's relu masks, normalised tensors and channel means, and six
# instance norms spread that, so nothing element-wise holds.  Each is
# held as the model's gradients are (test_torch_port_bf16_train's
# ``GAP_SHARE``): its distance from JAX's bf16 VJP, as a share of the
# distance from there to the fp32 VJP on the same inputs (2-norms; the
# port's fp32 encoders, which test_torch_port_encoder_train holds to
# JAX's within 1e-3), for the image's cotangent and for all parameter
# gradients as one vector.  Measured: fnet at 6 images 0.62 / 0.65, at
# 2 images 0.51 / 0.53, cnet 0.34 / 0.43.  The stages themselves are held
# element-wise above.
ENC_GAP_SHARE = 0.8


def _gap(got, want, fp32) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(fp32 - want))


@pytest.mark.parametrize("kind,images", [("fnet", 6), ("fnet", 2),
                                         ("cnet", 1)],
                         ids=["fnet_6", "fnet_2", "cnet_1"])
def test_encoder_bf16_vjp_matches_jax(fused_vars, kind, images, cpu_sums):
    """``BasicEncoder`` (6 images: the bf16 conv1 module, then
    ``stem_layer1`` with row 10's sums; 2 images: ``conv1_stem_layer1``)
    and ``MultiBasicEncoder`` (frozen batch norm, 1 image:
    ``bn_conv1_stem_layer1``) fused in bf16, against ``jax.vjp`` of the
    JAX encoders with ``fused_stem=True`` and ``dtype=bfloat16``, given
    the same bf16 image and output cotangent: the image's cotangent and
    every parameter's gradient (conv kernels and biases, the norms'
    weights and biases), each within ``ENC_GAP_SHARE`` of the
    bf16-vs-fp32 distance, all finite, every parameter reached."""
    v = fused_vars
    rng = np.random.default_rng(images)
    x = _bf(rng, (images,) + HW + (3,))
    cot = _cotangent(rng, jax.eval_shape(_jax_apply(v, kind, JBF),
                                         v["params"][kind], x))
    _, (dp, dx) = _jax_encoder_vjp(v, kind, JBF, x, cot)
    want = _encoder_grads_sd(kind, dp)
    dxt, got = _port_encoder_vjp(v, kind, x, cot)
    dx32, got32 = _port_encoder_vjp(
        v, kind, x.astype(jnp.float32),
        jax.tree.map(lambda c: c.astype(jnp.float32), cot))
    assert _gap(dxt, _np(dx), dx32) <= ENC_GAP_SHARE
    assert set(got) == set(want)
    names = sorted(want)
    for k in names:
        assert got[k].dtype == torch.float32, k
        assert float(got[k].abs().max()) > 0, k
    flat = [np.concatenate([_np(d[k]).ravel() for k in names])
            for d in (got, want, got32)]
    assert np.isfinite(flat[0]).all()
    assert _gap(*flat) <= ENC_GAP_SHARE


# ------------------------------------------------------------ the model

def _pin_encoders(port, couts, fmaps):
    """The port's encoders run, but their outputs take the values of the
    JAX fused encoders' (as bf16 leaves ``pc``, ``pf``), so the GRU sees
    JAX's features while the gradients flow through the fused stages."""
    pc = [[torch.from_numpy(_np(o).copy()).to(BF).permute(0, 3, 1, 2)
           .contiguous().requires_grad_() for o in lvl] for lvl in couts]
    pf = torch.from_numpy(_np(fmaps).copy()).to(BF).permute(
        0, 3, 1, 2).contiguous().requires_grad_()
    cnet, fnet = port.cnet.forward, port.fnet.forward
    port.cnet.forward = lambda x: [[_Pin.apply(o, p) for o, p in zip(lo, lp)]
                                   for lo, lp in zip(cnet(x), pc)]
    port.fnet.forward = lambda x: _Pin.apply(fnet(x), pf)
    return pc, pf


def _port_train(v, couts, fmaps, **kw):
    """The port in bf16 train mode, ``fused_encoder=True``, its encoders'
    outputs pinned to JAX's: the loss, the predictions, every parameter's
    gradient and the cotangents reaching the pinned outputs."""
    port = _port_model(v, compute_dtype="bfloat16", fused_encoder=True,
                       **kw)
    pc, pf = _pin_encoders(port, couts, fmaps)
    i1, i2, gt, valid = (torch.from_numpy(a) for a in _batch())
    preds = port(i1, i2, iters=ITERS, test_mode=False)
    loss = sequence_loss(preds, gt, valid)[0]
    loss.backward()
    return dict(loss=float(loss.detach()), preds=_np(preds),
                params={k: p.grad for k, p in port.named_parameters()},
                couts=[_np(o.grad).transpose(0, 2, 3, 1) for lvl in pc
                       for o in lvl],
                fmaps=_np(pf.grad).transpose(0, 2, 3, 1))


def _norm_images(dtype):
    i1, i2, _, _ = _batch()

    def norm(img):
        return (2.0 * (jnp.asarray(img) / 255.0) - 1.0).astype(dtype)

    return norm(i1), jnp.concatenate([norm(i1), norm(i2)], 0)


def _encoder_vjps(v, run, dtype):
    """The fused encoders' parameter gradients on the batch's images for
    the cotangents that ``run`` (``_jax_train``) gave their outputs: in
    bf16, JAX's (in the port's names, and as JAX trees by encoder); in
    fp32, the port's (the yardstick, as in the encoder test)."""
    cimg, fimg = _norm_images(dtype)
    couts = iter(run["couts"])
    cc = [[jnp.asarray(next(couts)).astype(dtype) for _ in range(2)]
          for _ in range(TINY["n_gru_layers"])]
    names, trees = {}, {}
    for kind, x, cot in (("cnet", cimg, cc),
                         ("fnet", fimg, jnp.asarray(run["fmaps"])
                          .astype(dtype))):
        if dtype == JBF:
            _, (trees[kind], _) = _jax_encoder_vjp(v, kind, dtype, x, cot)
            names.update(_encoder_grads_sd(kind, trees[kind]))
        else:
            names.update(_port_encoder_vjp(v, kind, x, cot)[1])
    return names, trees


@pytest.fixture(scope="module")
def jax_runs(fused_vars):
    """The JAX fused bf16 encoders' outputs on the batch's images (the
    pinned values); ``jax.grad`` of the JAX model with those outputs
    given, in bf16 at both correlation dtypes, on the bf16 ``pallas``
    volume, and in fp32; the fused encoders' parameter gradients for each
    run's cotangents (``_encoder_vjps``)."""
    v = fused_vars
    cimg, fimg = _norm_images(JBF)
    (couts, _), (fmaps, _) = (
        _jax_encoder_vjp(v, kind, JBF, x, _cotangent(
            np.random.default_rng(0), jax.eval_shape(
                _jax_apply(v, kind, JBF), v["params"][kind], x)))
        for kind, x in (("cnet", cimg), ("fnet", fimg)))
    bf16 = dict(compute_dtype="bfloat16")
    runs = {"bfloat16": dict(bf16, corr_dtype="bfloat16"),
            "float32": dict(bf16, corr_dtype="float32"),
            "pallas": dict(bf16, corr_dtype="bfloat16",
                           corr_implementation="pallas"),
            "fp32": {}}
    runs = {k: _jax_train(v, couts, fmaps, **kw) for k, kw in runs.items()}
    for k, run in runs.items():
        run["encoders"], run["encoder_trees"] = _encoder_vjps(
            v, run, jnp.float32 if k == "fp32" else JBF)
    return couts, fmaps, runs


def _flat_encoders(grads, names):
    return np.concatenate([_np(grads[k]).ravel() for k in names])


def _check_encoders(port, want, fp32):
    """The fused encoders' parameter gradients, as one vector: nearer
    JAX's bf16 run than JAX's fp32 run is (``GAP_SHARE``)."""
    names = sorted(want["encoders"])
    assert len(names) > 50 and set(names) <= set(port["params"])
    flat = [_flat_encoders(port["params"], names),
            _flat_encoders(want["encoders"], names),
            _flat_encoders(fp32["encoders"], names)]
    assert np.isfinite(flat[0]).all() and np.abs(flat[1]).max() > 0
    return _ratio(*flat)



@pytest.mark.parametrize("corr_dtype", ["bfloat16", "float32"])
def test_train_bf16_fused_matches_jax(fused_vars, jax_runs, corr_dtype,
                                      cpu_sums):
    """The TINY model in bf16 train mode with ``fused_encoder=True`` (at 1
    pair: fnet's 2 images take ``conv1_stem_layer1``, cnet's
    ``bn_conv1_stem_layer1``) against ``jax.grad`` of the JAX bf16 model,
    the encoders' outputs pinned to the JAX fused encoders' with their
    gradients flowing into the fused stages' backward: the predictions,
    the loss, the non-encoder gradients and the cotangents reaching the
    encoders' outputs as ``test_torch_port_bf16_train`` holds them, and
    every fused-encoder parameter's gradient, each nearer JAX's bf16 run
    than JAX's fp32 run is (``GAP_SHARE``; the fp32 encoders' gradients
    are the port's, as in ``test_encoder_bf16_vjp_matches_jax``).
    Measured (bf16 / fp32 correlation): loss 3.5e-4 / 5.6e-5 relative,
    predictions 0.094 / 0.070 px; shares: predictions 0.19 / 0.17,
    non-encoder gradients 0.43 / 0.23, fnet's cotangent 0.46 / 0.30,
    cnet's 0.49 / 0.33, the encoders' gradients 0.54 / 0.43."""
    couts, fmaps, runs = jax_runs
    port = _port_train(fused_vars, couts, fmaps, corr_dtype=corr_dtype)
    _check_train(port, runs[corr_dtype], runs["fp32"])
    assert _check_encoders(port, runs[corr_dtype], runs["fp32"]) <= GAP_SHARE


def test_train_bf16_pallas_volume_matches_jax(fused_vars, jax_runs,
                                              cpu_sums):
    """Training on the bf16 ``pallas`` volume (rounded once from the fp32
    product, pooled level by level; row 6's fp32 ``dvol`` cast to the
    volume's bf16) against the JAX bf16 model with
    ``corr_implementation="pallas", corr_dtype="bfloat16"``, by the same
    rule: the gradient reaches both feature maps (fnet's cotangent)
    through the bf16 pooling and the bf16 volume product.  The fp32 run
    that measures JAX's gap is ``pallas_alt``'s, the same function in
    fp32 (with the fp32 ``pallas`` run instead the shares agree to 1e-6).
    Measured: loss 3.4e-4 relative, predictions 0.109 px; shares:
    predictions 0.24, non-encoder gradients 0.58, fnet's cotangent 0.65
    (the bf16 volume's flips, spread by the GRU, against 0.30-0.46 on
    the on-demand lookup), cnet's 0.52, the encoders' gradients 0.61.
    With ``corr_quant=True`` training takes the same unquantized volume,
    as the JAX package does: every bit of the run without it."""
    couts, fmaps, runs = jax_runs
    port = _port_train(fused_vars, couts, fmaps, corr_dtype="bfloat16",
                       corr_implementation="pallas")
    _check_train(port, runs["pallas"], runs["fp32"])
    assert _check_encoders(port, runs["pallas"], runs["fp32"]) <= GAP_SHARE
    quant = _port_train(fused_vars, couts, fmaps, corr_dtype="bfloat16",
                        corr_implementation="pallas", corr_quant=True)
    assert quant["loss"] == port["loss"]
    assert np.array_equal(quant["fmaps"], port["fmaps"])
    for k, g in port["params"].items():
        assert torch.equal(quant["params"][k], g), k


# One AdamW step from zero moments moves each entry by about lr * sign(g),
# whatever |g| is, so parameters alone hardly see the gradient.  The
# step is held in parts.  The gradients it hands its clip: the model
# test's rule on all of them as one vector (measured 0.47).  The update:
# the JAX package's optimizer applied to those same gradients gives every
# parameter to ``STEP_ULPS`` fp32 ulps of max(|p|, lr) (measured 3.8: the
# update's own roundings).  Against JAX's step on JAX's gradients, the
# share of entries within 0.01 lr of it is the share whose gradient sign
# the port and JAX agree on: measured 0.93 of all entries.  Per tensor it
# falls to 0.23 for a bias ahead of an instance norm (analytic gradient 0,
# so its sign is rounding noise) and to 0.62 in the GRU that compounds the
# rounding over the iterations; a step with a wrong sign or no gradient
# would agree nowhere.
STEP_ULPS, STEP_AGREE = 8.0, 0.85


def test_one_bf16_fused_step_params_match_jax(fused_vars, jax_runs,
                                              cpu_sums, monkeypatch):
    """One ``make_train_step`` of the bf16 fused model, encoders' outputs
    pinned as above, against the JAX package's optimizer (its
    ``make_optimizer``: global-norm clip, AdamW on the one-cycle schedule):
    the loss within 6e-4 of ``jax.grad``'s run; the gradients the step
    took nearer JAX's bf16 gradients than JAX's fp32 ones are
    (``GAP_SHARE``); the port's updated parameters equal, to
    ``STEP_ULPS``, JAX's optimizer applied to those gradients; every fused
    encoder parameter moved by about lr; and the parameters agree with
    JAX's whole step (JAX's gradients, JAX's optimizer) to 0.01 lr on at
    least ``STEP_AGREE`` of the entries."""
    v = fused_vars
    couts, fmaps, runs = jax_runs
    run, fp32 = runs["bfloat16"], runs["fp32"]
    tcfg = JaxTrainConfig(batch_size=1, image_size=HW, train_iters=ITERS,
                          data_parallel=1)
    tx, schedule = jax_make_optimizer(tcfg)
    update = jax.jit(lambda p, g: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))

    def jax_step(tree):
        return variables_to_state_dict(
            {"params": jax.device_get(update(v["params"], tree))})

    took, clip = {}, tstep.clip_by_global_norm

    def clip_took(grads, norm, max_norm):
        took.update((k, g.clone()) for k, g in grads.items())
        return clip(grads, norm, max_norm)

    monkeypatch.setattr(tstep, "clip_by_global_norm", clip_took)
    port = _port_model(v, compute_dtype="bfloat16", fused_encoder=True,
                       corr_dtype="bfloat16")
    _pin_encoders(port, couts, fmaps)
    cfg = TrainConfig(batch_size=1, image_size=HW, train_iters=ITERS)
    opt, sched = make_optimizer(cfg, dict(port.named_parameters()))
    state = TrainState(step=0, model=port, opt=opt)
    metrics = make_train_step(cfg, sched)(
        state, tuple(torch.from_numpy(a) for a in _batch()))
    lr = float(schedule(0))
    assert metrics["lr"] == lr and state.step == 1 and opt.count == 1
    assert metrics["loss"] == pytest.approx(run["loss"], rel=6e-4)
    got = {k: t.detach() for k, t in port.named_parameters()}
    names = sorted(got)
    # the gradients the step took
    want_g = dict(run["params"], **run["encoders"])
    fp32_g = dict(fp32["params"], **fp32["encoders"])
    assert set(took) == set(want_g) == set(names)
    flat = [np.concatenate([_np(d[k]).ravel() for k in names])
            for d in (took, want_g, fp32_g)]
    assert np.isfinite(flat[0]).all() and _ratio(*flat) <= GAP_SHARE
    # the update
    mine = jax_step(state_dict_to_variables(took)["params"])
    start = variables_to_state_dict(v)
    for k in names:
        ulp = torch.maximum(mine[k].abs(), torch.tensor(lr)) * 2.0 ** -23
        assert float(((got[k] - mine[k]).abs() / ulp).max()) <= STEP_ULPS, k
        if k.startswith(("fnet.", "cnet.")):
            assert float((got[k] - start[k]).abs().max()) > 0.5 * lr, k
    # against JAX's whole step
    want = jax_step(dict(run["tree"], **run["encoder_trees"]))
    close = sum(int(((got[k] - want[k]).abs() <= 0.01 * lr).sum())
                for k in names)
    assert close >= STEP_AGREE * sum(got[k].numel() for k in names)


# ----------------------------------------------------------------- CLI

@pytest.mark.parametrize("corr_dtype", ["bfloat16", "float32"])
def test_cli_train_runs_the_fused_encoder_bf16(tmp_path, monkeypatch,
                                               corr_dtype):
    """``cli.train.train`` with the fused encoder in bf16 on the CPU: two
    finite steps and a checkpoint, at both correlation dtypes.  (No
    TensorBoard writer: importing it costs more than the run.)"""
    monkeypatch.setattr(tlogger, "_make_tb_writer", lambda log_dir: None)
    cfg = TrainConfig(name="t", batch_size=1, num_steps=1, train_iters=2,
                      image_size=HW, checkpoint_dir=str(tmp_path / "ckpt"),
                      validation_frequency=1, seed=3)
    model_cfg = RAFTStereoConfig(fused_encoder=True, n_gru_layers=2,
                                 hidden_dims=(16, 16), corr_levels=2,
                                 corr_radius=2, compute_dtype="bfloat16",
                                 corr_dtype=corr_dtype)
    state = cli_train.train(model_cfg, cfg,
                            dataset=ShiftStereoDataset(n=2, hw=HW),
                            num_workers=0, no_validation=True, device="cpu",
                            log_dir=str(tmp_path / "runs"))
    assert state.step == 2
    assert state.model.fnet.conv1.weight.dtype == torch.float32
    with open(tmp_path / "runs" / "metrics.jsonl") as f:
        losses = [r["live_loss"] for r in map(json.loads, f)
                  if "live_loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert list((tmp_path / "ckpt" / "t").glob("*"))


def test_profile_files_the_bf16_dual_sums():
    """``cli/profile.py`` files both forms of row 14's kernel (the
    template's fp32 and bf16 instances, as the profiler names them) under
    "dual_sums", and the stats kernel's under "enc_stats"."""
    for t in ("float", "__nv_bfloat16"):
        name = (f"void (anonymous namespace)::enc_dual_sums_kernel<{t}>("
                f"{t} const*, {t} const*, float*, int, long)")
        assert cli_profile._group(name) == "dual_sums"
        assert cli_profile._group(name.replace(
            "enc_dual_sums_kernel", "enc_plane_stats_kernel")) == "enc_stats"
