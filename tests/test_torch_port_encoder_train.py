"""Training through the port's fused encoder stages, against the JAX
package on the CPU.

The JAX side runs its fused stages' custom VJPs as its own tests run
them off the TPU: Pallas kernels in interpret mode, and the instance-norm
backward's dual-sum kernel forced (``pallas_encoder._bwd_packed_sums =
True`` for this module, as ``tests/test_pallas_encoder.py`` forces it).
The port's stage Functions run their backward (``ops.encoder_bwd``) with
the kernel wrappers' plain versions.  Inputs are made with numpy from a
seed; activations are NHWC on the JAX side and NCHW in the port, conv
weights HWIO and OIHW.

The stages' gradient is the JAX package's hand-written backward, not the
autodiff of the plain encoders: the backward rebuilds each norm from its
saved affine and takes JAX's 0.5 derivative of max(z, 0) at z == 0.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_encoder import (TINY, B, C, H, W, _affines, _conv,
                                     _convs, _layer2_params, _nchw)

from raftstereo_tpu import RAFTStereoConfig as JaxConfig
from raftstereo_tpu.models import RAFTStereo as JaxModel
from raftstereo_tpu.ops import pallas_encoder as pe
from raftstereo_tpu.ops import pallas_layer2 as pl2
from raftstereo_tpu.train.loss import sequence_loss as jax_sequence_loss
from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig
from raftstereo_tpu_torch.cli import train as cli_train
from raftstereo_tpu_torch.config import TrainConfig
from raftstereo_tpu_torch.data.synthetic import ShiftStereoDataset
from raftstereo_tpu_torch.ops import cuda_encoder as ce
from raftstereo_tpu_torch.ops import encoder_bwd as eb
from raftstereo_tpu_torch.ops import encoder_stage as es
from raftstereo_tpu_torch.train import logger as tlogger
from raftstereo_tpu_torch.train.loss import sequence_loss
from raftstereo_tpu_torch.utils.convert import variables_to_state_dict

HW = (32, 48)
ITERS = 3
STAGE = ("c10", "c11", "c20", "c21")
LAYER2 = ("c1", "c2", "c3", "c4", "proj")  # jax.tree.leaves' sorted order
# The tie case: norm1's and layer1_0.norm2's frozen-BN affines are dead
# (s = t = 0) in 6 of 8 channels.  There t0 and u2, their pre-activations
# and t0 + u2 are exactly 0, and the derivative of max(z, 0) at 0 decides
# those affines' gradients.  (A tie of t0 + u2 alone, with both
# pre-activations below 0, changes no gradient: the masks after it are 0.)
TIE_AFFINES, TIE_CHANNELS = (0, 2), 6


@pytest.fixture(scope="module", autouse=True)
def packed_sums():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pe, "_bwd_packed_sums", True)
        yield


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: these shapes are tiny, and a full thread pool
    per process spins idle when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def assert_tree_close(got, want, rtol=1e-3):
    """The JAX stage gradient tests' tolerance
    (``tests/test_pallas_encoder.py`` ``assert_tree_close``): atol keyed
    to the gradient tree's scale, since conv biases ahead of an instance
    norm have an analytic gradient of 0 and both frameworks give rounding
    noise there.  Returns that atol."""
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    assert len(got) == len(want)
    scale = max(float(np.abs(w).max()) for w in want)
    atol = 1e-4 * (1.0 + scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    return atol


def _case(name):
    """One entry point's seeded inputs, JAX trees: (x, conv1 params or
    None, stage params, affines or None, stride)."""
    rng = np.random.default_rng(5)
    stride = 2 if name.endswith("s2") else 1
    c1 = None
    if "conv1" in name:
        x = rng.normal(size=(B, H, W, 3)).astype(np.float32)
        c1, _ = _conv(rng, 7, 3, C)
    elif name.startswith("layer2"):
        x = np.abs(rng.normal(size=(B, H, W, C))).astype(np.float32)
    else:  # conv1's raw output
        x = (rng.normal(size=(B, H, W, C)) * 2 + 0.3).astype(np.float32)
    if name.startswith("layer2"):
        params, _ = _layer2_params(rng, C, 12)
    else:
        params, _ = _convs(rng, STAGE, 3, C, C)
    affines = None
    if "bn" in name:
        affines, _ = _affines(rng, 12 if name.startswith("layer2") else C)
        if name.endswith("ties"):
            dead = jnp.arange(C) < TIE_CHANNELS
            affines = [(jnp.where(dead, 0.0, s), jnp.where(dead, 0.0, t))
                       if i in TIE_AFFINES else (s, t)
                       for i, (s, t) in enumerate(affines)]
    return x, c1, params, affines, stride


def _jax_grads(name, x, c1, params, affines, stride):
    """``jax.grad`` of sum(out^2) with respect to every input."""
    if name.startswith("conv1"):
        def f(x, c1, p):
            return pe.conv1_stem_layer1(x, c1, p, jnp.float32, stride)
        args = (x, c1, params)
    elif name.startswith("bn_conv1"):
        def f(x, c1, p, a):
            return pe.bn_conv1_stem_layer1(x, c1, p, a, jnp.float32, stride)
        args = (x, c1, params, affines)
    elif name == "stem":
        f, args = pe.stem_layer1, (x, params)
    elif name.startswith("bn_stem"):
        f, args = pe.bn_stem_layer1, (x, params, affines)
    elif name == "layer2":
        f, args = pl2.fused_layer2, (x, params)
    else:
        f, args = pl2.fused_layer2_bn, (x, params, affines)
    loss = jax.grad(lambda *a: (f(*a) ** 2).sum(),
                    argnums=tuple(range(len(args))))
    return jax.jit(loss)(*(jax.tree.map(jnp.asarray, a) for a in args))


def _leaf(a):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_()


def _port(tree, names):
    """JAX {name: {kernel, bias}} -> port {name: (OIHW weight, bias)}."""
    return {n: (_leaf(np.asarray(tree[n]["kernel"]).transpose(3, 2, 0, 1)),
                _leaf(tree[n]["bias"])) for n in names}


def _port_grads(name, x, c1, params, affines, stride):
    """The port's gradients of sum(out^2), in the JAX trees' leaf order
    and layouts (bias before kernel: jax.tree.leaves sorts dict keys)."""
    names = LAYER2 if name.startswith("layer2") else STAGE
    tx, tp = _leaf(_nchw(x)), _port(params, names)
    tc1 = _port({"c1": c1}, ("c1",))["c1"] if c1 is not None else None
    ta = [(_leaf(s), _leaf(t)) for s, t in affines] if affines else None
    if name.startswith("conv1"):
        out = es.conv1_stem_layer1(tx, tc1, tp, stride)
    elif name.startswith("bn_conv1"):
        out = es.bn_conv1_stem_layer1(tx, tc1, tp, ta, stride)
    elif name == "stem":
        out = es.stem_layer1(tx, tp)
    elif name.startswith("bn_stem"):
        out = es.bn_stem_layer1(tx, tp, ta)
    elif name == "layer2":
        out = es.fused_layer2(tx, tp)
    else:
        out = es.fused_layer2_bn(tx, tp, ta)
    (out ** 2).sum().backward()
    convs = ([tc1] if tc1 is not None else []) + [tp[n] for n in names]
    got = [tx.grad.numpy().transpose(0, 2, 3, 1)]
    for w, b in convs:
        got += [b.grad.numpy(), w.grad.numpy().transpose(2, 3, 1, 0)]
    if ta:
        got += [t.grad.numpy() for pair in ta for t in pair]
    return got, out


@pytest.mark.parametrize("name", [
    "conv1_s1", "conv1_s2", "bn_conv1_s1", "stem", "bn_stem", "layer2",
    "layer2_bn"])
def test_stage_gradients_match_jax(name):
    """Each entry point's gradients with respect to its input, conv
    weights and biases and frozen-BN affines, against ``jax.grad`` of the
    JAX function (its custom VJP), on 2 images at 16x24, 8 channels."""
    case = _case(name)
    got, out = _port_grads(name, *case)
    assert float(out.detach().max()) > 0.5  # a non-trivial stage
    assert_tree_close(got, _jax_grads(name, *case))


def test_relu_ties_take_half_the_gradient(monkeypatch):
    """Where most of t0 + u2 is exactly 0, the port agrees with JAX, and a
    backward with ``F.relu``'s tie convention (derivative 0 at 0) differs
    from JAX by far more than the tolerance: the stage comparison can
    see the convention."""
    case = _case("bn_stem_ties")
    x, _, params, affines, _ = case
    aff = es._per_image([(torch.from_numpy(np.asarray(s)),
                          torch.from_numpy(np.asarray(t)))
                         for s, t in affines], B)
    tp = {n: (w.detach(), b.detach())
          for n, (w, b) in _port(params, STAGE).items()}
    with torch.no_grad():
        y1 = _nchw(x)
        _, (_, c11, _, _), _ = es._stage(y1, aff[0], tp, 1.0, aff[1:])
        z1 = ce.prep(y1, aff[0]) + ce.prep(c11, aff[2])
    assert float((z1 == 0).float().mean()) >= 0.75

    want = _jax_grads("bn_stem_ties", *case)
    got, _ = _port_grads("bn_stem_ties", *case)
    atol = assert_tree_close(got, want)
    monkeypatch.setattr(eb, "drelu", lambda z: (z > 0).to(z.dtype))
    wrong, _ = _port_grads("bn_stem_ties", *case)
    gap = max(float(np.abs(a - np.asarray(w)).max())
              for a, w in zip(wrong, jax.tree.leaves(want)))
    assert gap > 100 * atol


def test_dual_sums_match_jax():
    """Row 14's plain version (the wrapper on CPU tensors) against the
    JAX package's ``_in_bwd_means`` through its Pallas kernel (interpret
    mode), as means over the plane."""
    rng = np.random.default_rng(8)
    u = rng.normal(size=(B, H, W, C)).astype(np.float32)
    v = (rng.normal(size=(B, H, W, C)) * 2 + 0.5).astype(np.float32)
    m1, m2 = pe._in_bwd_means(jnp.asarray(u), jnp.asarray(v))
    s1, s2 = ce.dual_sums(_nchw(u), _nchw(v))
    for got, want in ((s1, m1), (s2, m2)):
        assert got.shape == (B, C)
        np.testing.assert_allclose(got.numpy() / (H * W),
                                   np.asarray(want)[:, 0, 0], rtol=1e-5,
                                   atol=1e-6)


# -------------------------------------------------- the model, trained

def _batch(batch):
    """Images, target and validity of one seeded batch; the seed is the
    batch size.  A pair can put a pre-activation within fp32 rounding of
    0, and then the two frameworks take opposite sides of that relu:
    with the JAX model's own init weights, the batch-1 pair of
    ``test_torch_port_train.py`` (seed 0) does so in the context head,
    and one output channel's weight gradient differs by 3e-3 of the
    largest gradient (measured; the port in float32 and float64 agree
    there to 2e-6, and the plain encoders show such flips at other seeds
    too)."""
    rng = np.random.default_rng(batch)
    i1, i2 = (rng.uniform(0, 255, (batch,) + HW + (3,)).astype(np.float32)
              for _ in range(2))
    gt = -rng.uniform(1, 20, (batch,) + HW + (1,)).astype(np.float32)
    valid = (rng.uniform(size=(batch,) + HW) > 0.1).astype(np.float32)
    return i1, i2, gt, valid


def _seeded_variables(shapes, seed=0):
    """Variables of the JAX model's tree made with numpy: He-normal conv
    kernels, zero biases, identity batch-norm scales, and running
    statistics away from their init (mean 0.3 i / n, var 1 + 0.3 i / n
    over each leaf's n entries) so that the frozen-BN affines are not the
    identity.  (Cheaper than compiling the model's ``init``.)"""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        ramp = 0.3 * np.arange(s.size, dtype=np.float32).reshape(
            s.shape) / s.size
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape)
                    * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if "batch_stats" in name:
            return (ramp + 1.0) if "var" in name else ramp
        if "scale" in name:
            return np.ones(s.shape, np.float32)
        return np.zeros(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def jax_model():
    """The JAX model with ``fused_encoder=True`` and seeded variables."""
    jmodel = JaxModel(JaxConfig(corr_implementation="pallas_alt",
                                gru_backend="xla", fused_encoder=True,
                                **TINY))
    shapes = jax.eval_shape(lambda k: jmodel.init(k, image_hw=HW),
                            jax.random.key(0))
    return jmodel, _seeded_variables(shapes)


@pytest.fixture(scope="module", params=[1, 3], ids=["batch1", "batch3"])
def trained(request, jax_model):
    """JAX and port: the train-mode loss and every parameter gradient of
    the TINY model with ``fused_encoder=True`` on one batch.  At batch 1
    fnet's 2 images take the conv1 stage, at batch 3 its 6 images take
    plain conv1 + ``stem_layer1``; cnet (frozen BN) likewise."""
    jmodel, v = jax_model
    i1, i2, gt, valid = _batch(request.param)

    def loss_fn(params):
        preds = jmodel.forward(dict(v, params=params), jnp.asarray(i1),
                               jnp.asarray(i2), iters=ITERS)
        return jax_sequence_loss(preds, jnp.asarray(gt),
                                 jnp.asarray(valid))[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    port = RAFTStereo(RAFTStereoConfig(fused_encoder=True, **TINY),
                      device="cpu")
    port.load_state_dict(variables_to_state_dict(v), strict=True)
    preds = port(torch.from_numpy(i1), torch.from_numpy(i2), iters=ITERS,
                 test_mode=False)
    loss_t, _ = sequence_loss(preds, torch.from_numpy(gt),
                              torch.from_numpy(valid))
    loss_t.backward()
    return (float(loss), variables_to_state_dict(
                {"params": jax.device_get(grads)}),
            float(loss_t.detach()),
            {k: p.grad for k, p in port.named_parameters()})


def test_fused_train_loss_matches_jax(trained):
    jloss, _, ploss, _ = trained
    assert np.isfinite(ploss) and ploss > 1.0
    assert ploss == pytest.approx(jloss, rel=1e-5)


def test_fused_train_gradients_match_jax(trained):
    """Every parameter's gradient within 1e-3 of the largest JAX gradient
    entry (``test_torch_port_train.py``'s bound): the frozen-BN weights
    and biases of both fused stages included."""
    _, gj, _, gp = trained
    assert set(gj) == set(gp)
    assert all(gp[k] is not None for k in gp)
    gmax = max(float(t.abs().max()) for t in gj.values())
    assert gmax > 1.0
    for k in ("cnet.norm1.weight", "cnet.layer1.0.norm2.bias",
              "cnet.layer2.0.downsample.1.weight"):
        assert float(gp[k].abs().max()) > 1e-3 * gmax, k
    for k, t in gj.items():
        err = float((gp[k] - t).abs().max())
        assert err <= 1e-3 * gmax, (k, err)


def test_cli_train_runs_the_fused_encoder(tmp_path, monkeypatch):
    """``cli.train.train`` with ``fused_encoder=True`` on the CPU: two
    finite steps and a checkpoint.  (No TensorBoard writer: importing it
    costs more than the run; the JSONL stream holds the losses.)"""
    monkeypatch.setattr(tlogger, "_make_tb_writer", lambda log_dir: None)
    cfg = TrainConfig(name="t", batch_size=1, num_steps=1, train_iters=2,
                      image_size=HW, checkpoint_dir=str(tmp_path / "ckpt"),
                      validation_frequency=1, seed=3)
    model_cfg = RAFTStereoConfig(fused_encoder=True, n_gru_layers=2,
                                 hidden_dims=(16, 16), corr_levels=2,
                                 corr_radius=2)
    state = cli_train.train(model_cfg, cfg,
                            dataset=ShiftStereoDataset(n=2, hw=HW),
                            num_workers=0, no_validation=True, device="cpu",
                            log_dir=str(tmp_path / "runs"))
    assert state.step == 2
    with open(tmp_path / "runs" / "metrics.jsonl") as f:
        losses = [r["live_loss"] for r in map(json.loads, f)
                  if "live_loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert list((tmp_path / "ckpt" / "t").glob("*"))
