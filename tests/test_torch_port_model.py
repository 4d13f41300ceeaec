"""The port's model against the JAX package on the CPU: the weight bridge,
the whole test-mode forward, config gating, the device rule and the
no-JAX import rule.

The forward is compared at a tiny config (hidden 32, 2 corr levels of
radius 2, 3 GRU levels, a 32x48 pair, 3 iterations) with the JAX package
run two ways: its TPU path forced onto the CPU (``pallas_alt`` lookup and
``fused`` GRU kernels in interpret mode, ``fused_encoder=False``) and its
XLA path (``reg`` / ``xla``).
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raftstereo_tpu import RAFTStereoConfig as JaxConfig
from raftstereo_tpu.models import RAFTStereo as JaxModel
from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig
from raftstereo_tpu_torch.utils.convert import (flatten_variables,
                                                load_weights_npz,
                                                variables_to_state_dict)

REPO = Path(__file__).resolve().parent.parent
TINY = dict(n_gru_layers=3, hidden_dims=(32, 32, 32), corr_levels=2,
            corr_radius=2)


def _jax_init(cfg, hw):
    model = JaxModel(cfg)
    v = jax.jit(lambda k: model.init(k, image_hw=hw))(jax.random.key(0))
    return model, jax.device_get(v)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def test_bridge_fills_every_tensor_at_default_width():
    """JAX init of the default-width config: every JAX leaf lands in
    exactly one torch tensor, every torch tensor is filled, values are
    the JAX values in torch layout."""
    _, v = _jax_init(JaxConfig(), (64, 96))
    model = RAFTStereo(RAFTStereoConfig(), device="cpu")
    sd = variables_to_state_dict(v)
    leaves = list(_leaves(v))
    assert len(sd) == len(leaves)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    got = model.state_dict()
    for key, t in sd.items():
        assert torch.equal(got[key], t), key
    # spot-check the layout of each kind of leaf
    k = np.asarray(v["params"]["fnet"]["conv1"]["kernel"])      # HWIO
    np.testing.assert_array_equal(got["fnet.conv1.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    bs = v["batch_stats"]["cnet"]["layer2_0"]["downsample_norm"]["var"]
    np.testing.assert_array_equal(
        got["cnet.layer2.0.downsample.1.running_var"].numpy(), bs)
    zr = v["params"]["update"]["gru0"]["convzr"]["kernel"]
    assert got["update_block.gru08.convzr.weight"].shape == (
        zr.shape[3], zr.shape[2], 3, 3)


def test_weights_npz_roundtrip(tmp_path):
    cfg = dict(n_gru_layers=1, hidden_dims=(32,), corr_levels=2,
               corr_radius=2)
    _, v = _jax_init(JaxConfig(**cfg), (32, 48))
    path = tmp_path / "w.npz"
    np.savez(path, **flatten_variables(v))
    a = RAFTStereo(RAFTStereoConfig(**cfg), device="cpu", seed=1)
    load_weights_npz(a, str(path))
    b = RAFTStereo(RAFTStereoConfig(**cfg), device="cpu", seed=2)
    b.load_state_dict(variables_to_state_dict(v))
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb)


@pytest.fixture(scope="module")
def tiny_pair():
    jcfg = JaxConfig(corr_implementation="pallas_alt", gru_backend="fused",
                     fused_encoder=False, **TINY)
    jmodel, v = _jax_init(jcfg, (32, 48))
    port = RAFTStereo(RAFTStereoConfig(**TINY), device="cpu")
    port.load_state_dict(variables_to_state_dict(v), strict=True)
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(0, 255, (1, 32, 48, 3)).astype(np.float32)
            for _ in range(2)]
    return jmodel, v, port, imgs


def _port_forward(port, imgs, iters, flow_init=None):
    lo, up = port(*(torch.from_numpy(i) for i in imgs), iters=iters,
                  flow_init=flow_init)
    return lo.numpy(), up.numpy()


# Thresholds of tests/test_torch_parity.py (2e-3 low-res, 5e-3 full-res):
# fp32 rounding differences between two frameworks, carried through three
# GRU iterations (disparities here are O(30) px).
@pytest.mark.parametrize("jax_path", [
    dict(corr_implementation="pallas_alt", gru_backend="fused"),
    dict(corr_implementation="reg", gru_backend="xla")],
    ids=["pallas_alt-fused", "reg-xla"])
def test_forward_matches_jax(tiny_pair, jax_path):
    _, v, port, imgs = tiny_pair
    jmodel = JaxModel(JaxConfig(fused_encoder=False, **jax_path, **TINY))
    lo, up = jmodel.forward(v, *(jnp.asarray(i) for i in imgs), iters=3,
                            test_mode=True)
    plo, pup = _port_forward(port, imgs, 3)
    assert plo.shape == (1, 8, 12, 1) and pup.shape == (1, 32, 48, 1)
    assert np.abs(np.asarray(lo)).max() > 1.0  # a non-trivial comparison
    np.testing.assert_allclose(plo, np.asarray(lo), rtol=0, atol=2e-3)
    np.testing.assert_allclose(pup, np.asarray(up), rtol=0, atol=5e-3)


def test_forward_flow_init_matches_jax(tiny_pair):
    jmodel, v, port, imgs = tiny_pair
    init = np.random.default_rng(1).uniform(-6, 0, (1, 8, 12, 1)).astype(
        np.float32)
    lo, up = jmodel.forward(v, *(jnp.asarray(i) for i in imgs), iters=2,
                            flow_init=jnp.asarray(init), test_mode=True)
    plo, pup = _port_forward(port, imgs, 2, torch.from_numpy(init))
    np.testing.assert_allclose(plo, np.asarray(lo), rtol=0, atol=2e-3)
    np.testing.assert_allclose(pup, np.asarray(up), rtol=0, atol=5e-3)


@pytest.mark.parametrize("field,value", [
    ("corr_implementation", "reg"), ("corr_implementation", "alt"),
    ("gru_backend", "xla"), ("corr_quant", True),
    ("compute_dtype", "bfloat16"), ("shared_backbone", True),
    ("input_mode", "sl"), ("spatial_shards", 2), ("context_norm", "group"),
    ("context_norm", "none"), ("slow_fast_gru", True)])
def test_unported_config_raises(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RAFTStereo(RAFTStereoConfig(**{field: value}), device="cpu")


def test_model_defaults_to_cuda_and_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RAFTStereo(RAFTStereoConfig(**TINY))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = sorted((REPO / "raftstereo_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "raftstereo_tpu")]
    assert not bad, bad
