"""The port's evaluation slice against the JAX package on the CPU: the
``Evaluator``, the KITTI, ETH3D, Things and Middlebury-F validators on
synthetic trees, ``tiled_infer`` and ``seam_gradient``, the demo CLI's
files, weight loading (upstream ``.pth``, ``save_weights``, flattened JAX
``.npz``, torch <-> JAX round trips), in-training validation through
``cli.train`` and the refusals.

Both sides run the TINY model (hidden 32, 2 corr levels of radius 2, 3
GRU levels) on the same numpy-seeded weights, 3 iterations, 60x90 pairs
(padded to 64x96).  The JAX side is its XLA path (``reg`` lookup, ``xla``
GRU step), jitted as its Evaluator jits it; the port runs its default
path (the lookup and update kernels' plain versions).  Tolerances:
predictions within 2e-3 of max(1, |disp|) (the forward tolerance of
PERF.md section 2), EPE within 1e-3 relative, and D1 equal except at
pixels whose error lies within that prediction tolerance of the D1
threshold, which the test counts and allows.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_port_encoder_train import _seeded_variables
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse

from raftstereo_tpu import RAFTStereoConfig as JaxConfig
from raftstereo_tpu.cli import demo as jax_demo
from raftstereo_tpu.data import datasets as jds
from raftstereo_tpu.data import synthetic as jsyn
from raftstereo_tpu.eval import Evaluator as JaxEvaluator
from raftstereo_tpu.eval import tiled as jtiled
from raftstereo_tpu.eval import validate as jax_validate
from raftstereo_tpu.eval import validate_things as jax_validate_things
from raftstereo_tpu.models import RAFTStereo as JaxModel
from raftstereo_tpu.utils.convert import load_state_dict, torch_to_variables
from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig
from raftstereo_tpu_torch.cli import common as tcommon
from raftstereo_tpu_torch.cli import demo as tdemo
from raftstereo_tpu_torch.cli import evaluate as tevaluate
from raftstereo_tpu_torch.cli import train as ttrain
from raftstereo_tpu_torch.data import datasets as tds
from raftstereo_tpu_torch.eval import Evaluator, tiled, validate
from raftstereo_tpu_torch.ops import alt_lookup
from raftstereo_tpu_torch.train import logger as tlogger
from raftstereo_tpu_torch.train.checkpoint import save_weights
from raftstereo_tpu_torch.utils.convert import (flatten_variables,
                                                state_dict_to_variables,
                                                variables_to_state_dict)

TINY = dict(n_gru_layers=3, hidden_dims=(32, 32, 32), corr_levels=2,
            corr_radius=2)
TINY_FLAGS = ["--n_gru_layers", "3", "--hidden_dims", "32", "32", "32",
              "--corr_levels", "2", "--corr_radius", "2"]
ITERS = 3
HW = (60, 90)
PRED_TOL = 2e-3
EPE_REL = 1e-3
THRESHOLDS = {"kitti": 3.0, "eth3d": 1.0, "things": 1.0, "middlebury_F": 2.0}


@pytest.fixture(scope="module")
def jax_side():
    jmodel = JaxModel(JaxConfig(corr_implementation="reg", gru_backend="xla",
                                **TINY))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0),
                                                image_hw=(64, 96)))
    jvars = _seeded_variables(shapes, seed=3)
    return jmodel, jvars, JaxEvaluator(jmodel, jvars, iters=ITERS)


@pytest.fixture(scope="module")
def port_model(jax_side):
    model = RAFTStereo(RAFTStereoConfig(**TINY), device="cpu")
    model.load_state_dict(variables_to_state_dict(jax_side[1]), strict=True)
    return model


class Recorder:
    """An evaluator that keeps every prediction."""

    def __init__(self, run):
        self.run, self.preds = run, []

    def __getattr__(self, name):
        return getattr(self.run, name)

    def __call__(self, image1, image2):
        self.preds.append(self.run(image1, image2))
        return self.preds[-1]


def _tree(kind, root):
    rng = np.random.default_rng(len(kind))
    if kind == "kitti":
        jsyn.make_synthetic_kitti(root, n=2, hw=HW, rng=rng)
        return [m.KITTI(aug_params=None, root=str(root)) for m in (jds, tds)]
    if kind == "eth3d":
        jsyn.make_synthetic_eth3d(root, n=2, hw=HW, rng=rng)
        return [m.ETH3D(aug_params=None, root=str(root)) for m in (jds, tds)]
    if kind == "things":
        jsyn.make_synthetic_things_test(root, n=2, hw=HW, rng=rng)
        return [m.SceneFlowDatasets(aug_params=None, root=str(root),
                                    dstype="frames_finalpass",
                                    things_test=True) for m in (jds, tds)]
    jsyn.make_synthetic_middlebury(root, hw=HW, rng=rng)
    return [m.Middlebury(aug_params=None, root=str(root), split="F")
            for m in (jds, tds)]


def _scored(kind, flow, valid):
    flow = flow[..., 0]
    if kind == "middlebury_F":
        return (valid >= -0.5) & (flow > -1000)
    if kind == "things":
        return (valid >= 0.5) & (np.abs(flow) < 192)
    return valid >= 0.5


@pytest.mark.parametrize("kind", sorted(THRESHOLDS))
def test_validators_match_jax(kind, tmp_path, jax_side, port_model):
    """Each validator's metrics and per-pair predictions against the JAX
    package's on the same tree and weights."""
    jmodel, jvars, jeval = jax_side
    jds_, tds_ = _tree(kind, tmp_path)
    kw = dict(warmup=0) if kind == "kitti" else {}
    jrec = Recorder(jeval)
    want = jax_validate(kind, jmodel, jvars, iters=ITERS, dataset=jds_,
                        evaluator=jrec, **kw)
    trec = Recorder(Evaluator(port_model, iters=ITERS))
    got = validate(kind, port_model, iters=ITERS, dataset=tds_,
                   evaluator=trec, **kw)
    assert set(got) == set(want)
    thr = THRESHOLDS[kind]
    border = scored = 0
    for i, (p, q) in enumerate(zip(trec.preds, jrec.preds, strict=True)):
        assert np.abs(p - q).max() <= PRED_TOL * max(1.0, np.abs(q).max())
        _, _, _, flow, valid = jds_[i]
        ok = _scored(kind, flow, valid)
        ep, eq = (np.abs(x - flow[..., 0])[ok] for x in (p, q))
        near = np.abs(eq - thr) <= PRED_TOL * max(1.0, np.abs(q).max())
        # outliers differ only where the JAX error sits at the threshold
        assert not ((ep > thr) != (eq > thr))[~near].any()
        border += int(near.sum())
        scored += int(ok.sum())
    for key in want:
        if key.endswith("-epe"):
            assert got[key] == pytest.approx(want[key], rel=EPE_REL)
        elif key.endswith("-d1"):
            assert abs(got[key] - want[key]) <= 100.0 * border / scored
    if kind == "kitti":
        assert got["kitti-fps"] > 0


def test_evaluator_counters_bitwise_and_batch_pad(port_model):
    """A first call per padded shape counts as the compile; every output
    equals a direct test-mode forward on the padded pair bitwise;
    ``batch_pad`` pads the batch with zero pairs."""
    rng = np.random.default_rng(1)
    a, b = (rng.uniform(0, 255, HW + (3,)).astype(np.float32)
            for _ in range(2))
    c = rng.uniform(0, 255, (40, 50, 3)).astype(np.float32)
    run = Evaluator(port_model, iters=2)
    flags = []
    for pair in ((a, b), (a, b), (c, c)):
        out = run(*pair)
        flags.append(run.last_included_compile)
        i1, i2, padder = run.pad(*pair)
        assert tuple(i1.shape) == (1,) + padder.bucket_hw + (3,)
        _, up = port_model(i1, i2, iters=2)
        assert np.array_equal(out, padder.unpad(up)[0, ..., 0].numpy())
    assert flags == [True, False, True]
    assert run.cache_stats == {"hits": 1, "misses": 2, "shapes": 2}
    assert run.latency.count == 3 and run.last_runtime > 0
    padded = Evaluator(port_model, iters=2, batch_pad=2)
    i1, _, _ = padded.pad(a, b)
    assert i1.shape[0] == 2 and not i1[1].any()
    # batch 2 runs the convolutions in other tilings: ~1e-5 px apart here
    np.testing.assert_allclose(padded(a, b), run(a, b), rtol=0, atol=1e-4)


def test_tiled_infer_matches_jax(jax_side, port_model):
    """Two 64x96 tiles over a 60x150 pair, blended, against the JAX
    package's ``tiled_infer``; the numpy planning and the seam metric are
    the JAX package's exactly."""
    jmodel, jvars, jeval = jax_side
    rng = np.random.default_rng(2)
    i1, i2 = (rng.uniform(0, 255, (60, 150, 3)).astype(np.float32)
              for _ in range(2))
    kw = dict(iters=ITERS, tile_hw=(64, 96), overlap=16, disp_margin=16)
    assert tiled.plan_geometry(60, 150, (64, 96), 16, 16)[3] == [0, 54]
    want = jtiled.tiled_infer(jmodel, jvars, i1, i2, infer_fn=jeval._fn, **kw)
    done = []
    got = tiled.tiled_infer(port_model, i1, i2,
                            callback=lambda d, t: done.append((d, t)), **kw)
    assert done == [(1, 2), (2, 2)]
    assert np.abs(got - want).max() <= PRED_TOL * max(1.0,
                                                      np.abs(want).max())
    gt = rng.uniform(-40, 0, got.shape).astype(np.float32)
    assert tiled.seam_gradient(got, gt) == jtiled.seam_gradient(got, gt)
    for args in ((150, 96, 64), (40, 64, 48), (1000, 300, 200)):
        assert tiled.plan_tiles(*args) == jtiled.plan_tiles(*args)
    for args in ((64, 96, 0, 54, 64, 150, 16, 16),
                 (64, 96, 10, 0, 120, 96, 16, 0)):
        np.testing.assert_array_equal(tiled.tile_weight(*args),
                                      jtiled.tile_weight(*args))
    batched = tiled.tiled_infer(port_model, i1, i2, tile_batch=3, **kw)
    # batch 3 runs the convolutions in other tilings: ~4e-5 px apart here
    np.testing.assert_allclose(batched, got, rtol=0, atol=1e-4)


def _upstream_state_dict(model):
    """An upstream-named state dict of ``model``'s weights: split GRU gate
    convs, the projection norm registered twice, batch-norm counters, the
    DataParallel prefix, wrapped in a ``state_dict`` key."""
    sd = {}
    for k, v in model.state_dict().items():
        if ".convzr." in k:
            z, r = torch.chunk(v, 2, dim=0)
            sd[k.replace("convzr", "convz")] = z.clone()
            sd[k.replace("convzr", "convr")] = r.clone()
            continue
        sd[k] = v.clone()
        if ".downsample.1." in k:
            sd[k.replace(".downsample.1.", ".norm3.")] = v.clone()
        if k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = (
                torch.tensor(7))
    return {"state_dict": {f"module.{k}": v for k, v in sd.items()}}


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory, jax_side, port_model):
    d = tmp_path_factory.mktemp("weights")
    paths = {"port": str(d / "w.pt"), "upstream": str(d / "w.pth"),
             "npz": str(d / "w.npz")}
    save_weights(paths["port"], port_model)
    torch.save(_upstream_state_dict(port_model), paths["upstream"])
    np.savez(paths["npz"], **flatten_variables(jax_side[1]))
    return paths


def test_weight_formats_load_to_equal_bits(weight_files, jax_side,
                                           port_model):
    """The three formats, told apart by their keys, load the same tensors
    and give bitwise-equal forwards; the JAX package's converter reads the
    synthetic ``.pth`` into the same weights."""
    rng = np.random.default_rng(4)
    i1, i2 = (torch.from_numpy(rng.uniform(0, 255, (1, 32, 64, 3))
                               .astype(np.float32)) for _ in range(2))
    want_sd = port_model.state_dict()
    want = port_model(i1, i2, iters=2)[1]
    for fmt, path in weight_files.items():
        m = RAFTStereo(RAFTStereoConfig(**TINY), device="cpu", seed=9)
        assert tcommon.load_weights_any(path, m) == fmt
        got_sd = m.state_dict()
        assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)
        assert torch.equal(m(i1, i2, iters=2)[1], want)
    jv = torch_to_variables(load_state_dict(weight_files["upstream"]),
                            jax_side[1], JaxConfig(**TINY))
    sd = variables_to_state_dict(jax.device_get(jv))
    assert all(torch.equal(sd[k], want_sd[k]) for k in want_sd)


def test_upstream_dead_levels_and_refusals(tmp_path):
    """A 2-level model loads an upstream file that carries the unused
    third level (the upstream model builds all three); a file of neither
    torch format, or one that does not fit the model, is refused."""
    m = RAFTStereo(RAFTStereoConfig(n_gru_layers=2, hidden_dims=(32, 32),
                                    corr_levels=2, corr_radius=2),
                   device="cpu")
    sd = _upstream_state_dict(m)
    sd["state_dict"]["module.update_block.gru32.convz.weight"] = (
        torch.zeros(3))
    sd["state_dict"]["module.update_block.gru32.convr.weight"] = (
        torch.zeros(3))
    sd["state_dict"]["module.cnet.layer5.0.conv1.weight"] = torch.zeros(3)
    torch.save(sd, tmp_path / "two.pth")
    fresh = RAFTStereo(m.config, device="cpu", seed=5)
    assert tcommon.load_weights_any(str(tmp_path / "two.pth"), fresh) == (
        "upstream")
    assert all(torch.equal(a, b) for a, b in zip(
        fresh.state_dict().values(), m.state_dict().values()))
    torch.save({"fnet.conv1.weight": torch.zeros(3)}, tmp_path / "junk.pt")
    with pytest.raises(ValueError, match="convzr"):
        tcommon.load_weights_any(str(tmp_path / "junk.pt"), fresh)
    three = RAFTStereo(RAFTStereoConfig(**TINY), device="cpu")
    with pytest.raises(RuntimeError):  # strict: a config mismatch
        tcommon.load_weights_any(str(tmp_path / "two.pth"), three)


def test_variables_round_trip_bitwise(jax_side, port_model):
    """torch -> JAX -> torch and JAX -> torch -> JAX give equal bits."""
    sd = port_model.state_dict()
    back = variables_to_state_dict(state_dict_to_variables(sd))
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    jv = jax_side[1]
    again = state_dict_to_variables(variables_to_state_dict(jv))
    flat, want = flatten_variables(again), flatten_variables(jv)
    assert set(flat) == set(want)
    assert all(np.array_equal(flat[k], want[k]) for k in want)


def test_evaluate_cli_same_metrics_from_each_file(weight_files, tmp_path,
                                                  capsys):
    """``cli.evaluate`` on a KITTI tree gives equal EPE and D1 from the
    ``.pth``, ``save_weights`` and ``.npz`` files of one set of weights,
    and warns that it evaluates random weights without one."""
    jsyn.make_synthetic_kitti(tmp_path / "k", n=2, hw=HW,
                              rng=np.random.default_rng(6))
    base = ["--dataset", "kitti", "--dataset_root", str(tmp_path / "k"),
            "--valid_iters", "2", "--device", "cpu"] + TINY_FLAGS
    results = []
    for path in weight_files.values():
        assert tevaluate.main(base + ["--restore_ckpt", path]) == 0
        results.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    assert results[0] == results[1] == results[2]
    assert set(results[0]) == {"kitti-epe", "kitti-d1"}
    assert np.isfinite(results[0]["kitti-epe"])
    assert tevaluate.main(base) == 0
    assert "RANDOM weights" in capsys.readouterr().err


def test_demo_cli_files_match_jax(weight_files, tmp_path, port_model,
                                  jax_side, monkeypatch):
    """``cli.demo`` writes the JAX demo's files (stems from the scene
    directories, since every left image is im0.png), with disparities
    within the prediction tolerance of the JAX demo's on the same weights
    (handed to it directly: its ``.pth`` conversion compiles an init, and
    the conversion is held above); the non-tiled ``.npy`` is the
    Evaluator's output negated; ``--tiled`` writes finite fields."""
    monkeypatch.setattr(jax_demo, "load_variables",
                        lambda path, config, model=None: jax_side[1])
    jsyn.make_synthetic_eth3d(tmp_path / "eth", n=2, hw=HW,
                              rng=np.random.default_rng(7))
    glob_l = str(tmp_path / "eth" / "two_view_training" / "*" / "im0.png")
    glob_r = glob_l.replace("im0", "im1")
    common = ["-l", glob_l, "-r", glob_r, "--save_numpy", "--valid_iters",
              str(ITERS), "--restore_ckpt", weight_files["upstream"]]
    assert jax_demo.main(common + ["--output_directory", str(tmp_path / "j"),
                                   "--corr_implementation", "reg",
                                   "--gru_backend", "xla"] + TINY_FLAGS) == 0
    assert tdemo.main(common + ["--output_directory", str(tmp_path / "t"),
                                "--device", "cpu"] + TINY_FLAGS) == 0
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [
        "scene0.npy", "scene0.png", "scene1.npy", "scene1.png"]
    run = Evaluator(port_model, iters=ITERS)
    for stem in ("scene0", "scene1"):
        got = np.load(tmp_path / "t" / f"{stem}.npy")
        want = np.load(tmp_path / "j" / f"{stem}.npy")
        assert np.abs(got - want).max() <= PRED_TOL * max(1.0,
                                                          np.abs(want).max())
        left = tdemo.load_image(str(tmp_path / "eth" / "two_view_training"
                                    / stem / "im0.png"))
        right = tdemo.load_image(str(tmp_path / "eth" / "two_view_training"
                                     / stem / "im1.png"))
        assert np.array_equal(got, -run(left, right))
        png = np.asarray(Image.open(tmp_path / "t" / f"{stem}.png"))
        assert png.shape == HW + (3,)
    assert tdemo.main(common + ["--output_directory", str(tmp_path / "tt"),
                                "--device", "cpu", "--tiled", "--tile_size",
                                "32", "64", "--tile_overlap", "8",
                                "--max_disparity", "16"] + TINY_FLAGS) == 0
    assert np.isfinite(np.load(tmp_path / "tt" / "scene0.npy")).all()


def test_in_training_validation_through_cli(tmp_path, monkeypatch, jax_side):
    """``cli.train`` validates on the FlyingThings3D TEST split every
    ``validation_frequency`` steps; the logged metrics are the JAX
    validator's on the same weights."""
    monkeypatch.setattr(tlogger, "_make_tb_writer", lambda log_dir: None)
    root = tmp_path / "data"
    jsyn.make_learnable_kitti(root, n=2, hw=(40, 56),
                              rng=np.random.default_rng(8))
    jsyn.make_synthetic_things_test(root, n=2, hw=HW,
                                    rng=np.random.default_rng(9))
    monkeypatch.chdir(tmp_path)
    assert ttrain.main([
        "--train_datasets", "kitti", "--dataset_root", str(root),
        "--batch_size", "1", "--image_size", "32", "48", "--train_iters", "2",
        "--valid_iters", "2", "--num_steps", "1", "--validation_frequency",
        "1", "--num_workers", "0", "--checkpoint_dir", str(tmp_path / "ck"),
        "--name", "v", "--device", "cpu"] + TINY_FLAGS) == 0
    with open(tmp_path / "runs" / "v" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    vals = [r for r in recs if "things-epe" in r]
    assert len(vals) == 2 and all(np.isfinite(r["things-d1"]) for r in vals)
    assert any(r.get("validation_skipped") == 0.0 for r in recs)
    final = torch.load(tmp_path / "ck" / "v" / "v-final.pt",
                       weights_only=True)
    jmodel = jax_side[0]
    want = jax_validate_things(
        jmodel, state_dict_to_variables(final), iters=2,
        dataset=jds.SceneFlowDatasets(aug_params=None, root=str(root),
                                      dstype="frames_finalpass",
                                      things_test=True))
    assert vals[-1]["things-epe"] == pytest.approx(want["things-epe"],
                                                   rel=EPE_REL)


def test_refusals(port_model):
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        Evaluator(port_model, mesh=object())
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        validate("sl", port_model)
    with pytest.raises(ValueError, match="unknown benchmark"):
        validate("kitti2012", port_model)
    f = torch.zeros((2, 8, 128))
    with pytest.raises(NotImplementedError,
                       match="Queue 1 item 2 \\(corr_precision"):
        alt_lookup.pallas_alt_pyramid_flat(f, f, torch.zeros((1, 2, 8, 2)),
                                           (8,), precision="high")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tevaluate.main(["--dataset", "kitti"] + TINY_FLAGS)
