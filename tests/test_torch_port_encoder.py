"""The port's fused encoder stages against the JAX package on the CPU.

The JAX side runs its fused stages as its own tests do off the TPU: the
public stage functions of ``ops/pallas_encoder.py`` and
``ops/pallas_layer2.py`` (Pallas kernels in interpret mode), and
``fused_encoder=True`` on its encoders and model.  The port runs the same
stages through its kernel wrappers, which take the plain PyTorch versions
for CPU tensors.  Inputs are made with numpy from a seed; images and
activations are NHWC on the JAX side and NCHW in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from raftstereo_tpu import RAFTStereoConfig as JaxConfig
from raftstereo_tpu.models import RAFTStereo as JaxModel
from raftstereo_tpu.models import encoders as jenc
from raftstereo_tpu.ops import pallas_encoder as pe
from raftstereo_tpu.ops import pallas_layer2 as pl2
from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig
from raftstereo_tpu_torch.models import encoders as tenc
from raftstereo_tpu_torch.ops import cuda_encoder as ce
from raftstereo_tpu_torch.ops import encoder_stage as es
from raftstereo_tpu_torch.utils.convert import variables_to_state_dict

# fp32 convolutions and sums taken in another order than XLA's packed
# kernels, through up to five convs and norms: the JAX stage tests' own
# tolerance for the fused stage against its XLA reference.
STAGE_TOL = dict(rtol=1e-4, atol=1e-4)
B, H, W, C = 2, 16, 24, 8
TINY = dict(n_gru_layers=3, hidden_dims=(32, 32, 32), corr_levels=2,
            corr_radius=2)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _conv(rng, k, ci, co):
    """A JAX conv's params and the port's (OIHW weight, bias)."""
    w = (rng.normal(size=(k, k, ci, co)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(co,)) * 0.1).astype(np.float32)
    return ({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
            (torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
             torch.from_numpy(b)))


def _convs(rng, names, k, ci, co):
    pairs = {n: _conv(rng, k, ci if i == 0 else co, co)
             for i, n in enumerate(names)}
    return ({n: p[0] for n, p in pairs.items()},
            {n: p[1] for n, p in pairs.items()})


def _affines(rng, c):
    """Five frozen-BN affines (s, t), one channel with a dead gamma (s=0,
    t=0.7: the output is relu(t) everywhere, also at the border)."""
    out = [(np.abs(rng.normal(size=(c,)) * 0.5 + 1).astype(np.float32),
            (rng.normal(size=(c,)) * 0.3).astype(np.float32))
           for _ in range(5)]
    out[1][0][0], out[1][1][0] = 0.0, 0.7
    return ([(jnp.asarray(s), jnp.asarray(t)) for s, t in out],
            [(torch.from_numpy(s), torch.from_numpy(t)) for s, t in out])


def _layer2_params(rng, ci, co):
    jp, tp = _convs(rng, ("c1",), 3, ci, co)
    jq, tq = _convs(rng, ("proj",), 1, ci, co)
    jr, tr = _convs(rng, ("c2", "c3", "c4"), 3, co, co)
    return {**jp, **jq, **jr}, {**tp, **tq, **tr}


def _stage_case(name, rng):
    """(JAX output, port output) of one stage on seeded inputs."""
    if name.startswith(("conv1", "bn_conv1")):
        stride = 2 if name.endswith("s2") else 1
        img = rng.normal(size=(B, H, W, 3)).astype(np.float32)
        jc1, tc1 = _conv(rng, 7, 3, C)
        jp, tp = _convs(rng, ("c10", "c11", "c20", "c21"), 3, C, C)
        if name.startswith("bn"):
            ja, ta = _affines(rng, C)
            want = jax.jit(pe.bn_conv1_stem_layer1, static_argnums=(4, 5))(
                jnp.asarray(img), jc1, jp, ja, jnp.float32, stride)
            got = es.bn_conv1_stem_layer1(_nchw(img), tc1, tp, ta, stride)
        else:
            want = jax.jit(pe.conv1_stem_layer1, static_argnums=(3, 4))(
                jnp.asarray(img), jc1, jp, jnp.float32, stride)
            got = es.conv1_stem_layer1(_nchw(img), tc1, tp, stride)
    elif name in ("stem", "stem_border", "bn_stem"):
        # The JAX fixture's raw conv1 output (*2 + 0.3); "stem_border"
        # centres it at -0.7 so norm1's prep shift -mean*rstd is > 0 in
        # every channel: padding before the prep would show at the border.
        shift = -0.7 if name == "stem_border" else 0.3
        y1 = (rng.normal(size=(B, H, W, C)) * 2 + shift).astype(np.float32)
        jp, tp = _convs(rng, ("c10", "c11", "c20", "c21"), 3, C, C)
        if name == "bn_stem":
            ja, ta = _affines(rng, C)
            want = jax.jit(pe.bn_stem_layer1)(jnp.asarray(y1), jp, ja)
            got = es.bn_stem_layer1(_nchw(y1), tp, ta)
        else:
            want = jax.jit(pe.stem_layer1)(jnp.asarray(y1), jp)
            got = es.stem_layer1(_nchw(y1), tp)
    else:
        co = 12
        t_in = np.abs(rng.normal(size=(B, H, W, C))).astype(np.float32)
        jp, tp = _layer2_params(rng, C, co)
        if name == "layer2_bn":
            ja, ta = _affines(rng, co)
            want = jax.jit(pl2.fused_layer2_bn)(jnp.asarray(t_in), jp, ja)
            got = es.fused_layer2_bn(_nchw(t_in), tp, ta)
        else:
            want = jax.jit(pl2.fused_layer2)(jnp.asarray(t_in), jp)
            got = es.fused_layer2(_nchw(t_in), tp)
    return np.asarray(want), _nhwc(got)


@pytest.mark.parametrize("name", [
    "conv1_s1", "conv1_s2", "bn_conv1_s1", "bn_conv1_s2", "stem",
    "stem_border", "bn_stem", "layer2", "layer2_bn"])
def test_stage_matches_jax(name):
    want, got = _stage_case(name, np.random.default_rng(7))
    assert got.shape == want.shape
    assert want.max() > 0.5  # a non-trivial comparison
    np.testing.assert_allclose(got, want, **STAGE_TOL)


def test_zero_padding_lives_in_the_prepped_domain():
    """On the border input of ``stem_border`` every channel's prep shift is
    positive, so a conv that zero-pads the RAW tensor before the prep
    differs from the right one by far more than the stage tolerance: the
    stage comparison above can see that fault."""
    rng = np.random.default_rng(7)
    y1 = _nchw((rng.normal(size=(B, H, W, C)) * 2 - 0.7).astype(np.float32))
    aff = es.in_affine(ce.stats_plain(y1), float(H * W))
    assert bool((aff[1] > 0.05).all())
    w = torch.from_numpy((rng.normal(size=(C, C, 3, 3)) * 0.2)
                         .astype(np.float32))
    right, _ = ce.conv_plain(y1, w, None, 1, aff, want_stats=False)
    wrong = F.conv2d(ce.prep(F.pad(y1, (1, 1, 1, 1)), aff), w)
    assert float((right - wrong).abs().max()) > 100 * STAGE_TOL["atol"]
    torch.testing.assert_close(right[..., 1:-1, 1:-1],
                               wrong[..., 1:-1, 1:-1])


def test_plane_stats_matches_jax():
    """Row 10 against the TPU stats kernel on the packed view, un-packed
    (the two pixel parities of a channel sum to its total)."""
    x = (np.random.default_rng(3).normal(size=(B, H, W, C)) * 2
         + 0.5).astype(np.float32)
    s1, s2 = pe._packed_stats(pe.pack_view(jnp.asarray(x)))
    g1, g2 = ce.plane_stats(_nchw(x))
    for got, packed in ((g1, s1), (g2, s2)):
        want = np.asarray(packed[:, 0, :C] + packed[:, 0, C:])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def _fused_models(**kw):
    """The JAX model with ``fused_encoder=True`` (its encoders' trunks at
    flagship widths: 64, 96, 128 channels, fnet 256 out; heads of 32),
    its seeded variables, and the port's model on the same weights."""
    jcfg = JaxConfig(fused_encoder=True, corr_implementation="pallas_alt",
                     gru_backend="fused", **TINY, **kw)
    jmodel = JaxModel(jcfg)
    v = jax.device_get(jax.jit(lambda k: jmodel.init(k, image_hw=(32, 48)))(
        jax.random.key(0)))
    port = RAFTStereo(RAFTStereoConfig(fused_encoder=True, **TINY, **kw),
                      device="cpu")
    port.load_state_dict(variables_to_state_dict(v), strict=True)
    return jmodel, v, port


@pytest.fixture(scope="module")
def fused_pair():
    """``_fused_models()`` at the default ``n_downsample=2``."""
    return _fused_models()


def _port_encoder(cls, prefix, jax_vars, **kw):
    enc = cls(**kw)
    tree = {coll: {prefix: sub[prefix]} for coll, sub in jax_vars.items()
            if prefix in sub}
    sd = {k[len(prefix) + 1:]: v
          for k, v in variables_to_state_dict(tree).items()}
    enc.load_state_dict(sd, strict=True)
    return enc.eval()


@pytest.mark.parametrize("kind,ds", [("fnet", 2), ("cnet", 2), ("cnet", 3)],
                         ids=["fnet", "cnet", "cnet_ds3"])
def test_encoder_matches_jax(fused_pair, kind, ds):
    """``BasicEncoder`` and ``MultiBasicEncoder`` with ``fused_stem=True``
    on one 32x48 image, the model's encoder weights: fnet (instance norm;
    the conv1 kernel, layer1, layer2), cnet (frozen BN with running
    statistics moved away from their init) and cnet at ``n_downsample=3``
    (the stride-2 conv1; its weights have the same shapes)."""
    _, v, _ = fused_pair
    x = np.random.default_rng(11).normal(size=(1, 32, 48, 3)).astype(
        np.float32)
    if kind == "fnet":
        jm = jenc.BasicEncoder(output_dim=256, norm_fn="instance",
                               downsample=ds, fused_stem=True)
        jv = {"params": v["params"]["fnet"]}
        want = [jax.jit(jm.apply)(jv, jnp.asarray(x))]
        port = _port_encoder(tenc.BasicEncoder, "fnet", v, output_dim=256,
                             norm_fn="instance", downsample=ds,
                             fused_stem=True)
    else:
        dims = (TINY["hidden_dims"],) * 2
        jm = jenc.MultiBasicEncoder(output_dims=dims, norm_fn="batch",
                                    downsample=ds, fused_stem=True)
        bs = jax.tree.map(lambda a: a + 0.3 * np.arange(a.size, dtype=a.dtype)
                          .reshape(a.shape) / a.size,
                          v["batch_stats"]["cnet"])
        jv = {"params": v["params"]["cnet"], "batch_stats": bs}
        want = [o for lvl in jax.jit(jm.apply)(jv, jnp.asarray(x))
                for o in lvl]
        port = _port_encoder(
            tenc.MultiBasicEncoder, "cnet",
            {"params": {"cnet": jv["params"]},
             "batch_stats": {"cnet": bs}},
            output_dims=dims, norm_fn="batch", downsample=ds, num_layers=3,
            fused_stem=True)
    with torch.inference_mode():
        out = port(_nchw(x))
    got = [out] if kind == "fnet" else [o for lvl in out for o in lvl]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=1e-4,
                                   atol=2e-4)


# Thresholds of tests/test_torch_port_model.py: fp32 rounding differences
# between two frameworks, carried through three GRU iterations.
@pytest.mark.parametrize("batch,ds", [(1, 2), (3, 2), (1, 3)],
                         ids=["1", "3", "ds3"])
def test_model_fused_encoder_matches_jax(fused_pair, batch, ds):
    """The whole test-mode forward with ``fused_encoder=True``.  At batch 3
    fnet sees 6 images, more than the fused conv1 takes: conv1 runs plain
    and the stage's first statistics come from the stats kernel (row 10),
    in both packages.  At ``n_downsample=3`` both encoders take the
    stride-2 conv1 (row 12), on a 32x64 pair (a 4x8 grid)."""
    jmodel, v, port = fused_pair if ds == 2 else _fused_models(
        n_downsample=ds)
    hw = (32, 48) if ds == 2 else (32, 64)
    rng = np.random.default_rng(batch)
    imgs = [rng.uniform(0, 255, (batch,) + hw + (3,)).astype(np.float32)
            for _ in range(2)]
    lo, up = jax.jit(lambda v, a, b: jmodel.forward(
        v, a, b, iters=3, test_mode=True))(v, *map(jnp.asarray, imgs))
    plo, pup = port(*(torch.from_numpy(i) for i in imgs), iters=3)
    lo_hw = (hw[0] // 2 ** ds, hw[1] // 2 ** ds)
    assert plo.shape == (batch,) + lo_hw + (1,)
    assert pup.shape == (batch,) + hw + (1,)
    assert np.abs(np.asarray(lo)).max() > 1.0
    np.testing.assert_allclose(plo.numpy(), np.asarray(lo), rtol=0, atol=2e-3)
    np.testing.assert_allclose(pup.numpy(), np.asarray(up), rtol=0, atol=5e-3)
