"""The port's training path against the JAX package on the CPU.

A tiny config (hidden 32, 2 corr levels of radius 2, 3 GRU levels, a
32x48 pair, 3 iterations) runs through the JAX package's TPU path forced
onto the CPU (``pallas_alt`` lookup with its Pallas kernels and their VJP
in interpret mode, ``gru_backend="xla"``, ``fused_encoder=False``) and
through the port's train mode (plain versions of the kernels), with the
same weights through the bridge and the same numpy inputs.  Gradients
are compared through the bridge too: every map it makes is a transpose,
so it maps a gradient tree like a parameter tree.

Also here: the schedule and optimizer against optax, ``nan_policy``,
``remat``, a preempted and resumed run against a straight one, the
copied data readers against the JAX package's, and the options
``train()`` refuses.
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_encoder_train import few_threads  # noqa: F401 autouse

from raftstereo_tpu import RAFTStereoConfig as JaxConfig
from raftstereo_tpu.config import TrainConfig as JaxTrainConfig
from raftstereo_tpu.data import datasets as jds
from raftstereo_tpu.data import loader as jloader
from raftstereo_tpu.data import synthetic as jsyn
from raftstereo_tpu.models import RAFTStereo as JaxModel
from raftstereo_tpu.train.loss import sequence_loss as jax_sequence_loss
from raftstereo_tpu.train.optim import make_optimizer as jax_make_optimizer
from raftstereo_tpu.train.optim import onecycle_lr as jax_onecycle_lr
from raftstereo_tpu.train.step import merge_skipped_update
from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig
from raftstereo_tpu_torch.cli import train as cli_train
from raftstereo_tpu_torch.config import TrainConfig
from raftstereo_tpu_torch.data import datasets as tds
from raftstereo_tpu_torch.data import loader as tloader
from raftstereo_tpu_torch.data import synthetic as tsyn
from raftstereo_tpu_torch.train.checkpoint import CheckpointManager
from raftstereo_tpu_torch.train.loss import sequence_loss
from raftstereo_tpu_torch.train.optim import make_optimizer, onecycle_lr
from raftstereo_tpu_torch.train.state import TrainState
from raftstereo_tpu_torch.train.step import make_train_step
from raftstereo_tpu_torch.utils.convert import variables_to_state_dict

TINY = dict(n_gru_layers=3, hidden_dims=(32, 32, 32), corr_levels=2,
            corr_radius=2)
HW = (32, 48)
ITERS = 3
# A smaller model for the loop-level tests, which take several steps.
LOOP = dict(n_gru_layers=2, hidden_dims=(16, 16), corr_levels=2,
            corr_radius=2)


def _inputs():
    rng = np.random.default_rng(0)
    i1, i2 = (rng.uniform(0, 255, (1,) + HW + (3,)).astype(np.float32)
              for _ in range(2))
    gt = -rng.uniform(1, 20, (1,) + HW + (1,)).astype(np.float32)
    valid = (rng.uniform(size=(1,) + HW) > 0.1).astype(np.float32)
    return i1, i2, gt, valid


@pytest.fixture(scope="module")
def case():
    """JAX and port: predictions, loss, metrics and gradients of one
    train-mode forward on the same weights and batch."""
    jcfg = JaxConfig(corr_implementation="pallas_alt", gru_backend="xla",
                     fused_encoder=False, **TINY)
    jmodel = JaxModel(jcfg)
    v = jax.device_get(jax.jit(lambda k: jmodel.init(k, image_hw=HW))(
        jax.random.key(0)))
    i1, i2, gt, valid = _inputs()

    def loss_fn(params):
        preds = jmodel.forward(dict(v, params=params), jnp.asarray(i1),
                               jnp.asarray(i2), iters=ITERS)
        loss, metrics = jax_sequence_loss(preds, jnp.asarray(gt),
                                          jnp.asarray(valid))
        return loss, (preds, metrics)

    (loss, (preds, metrics)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    jax_out = dict(loss=float(loss), preds=np.asarray(preds),
                   metrics={k: float(m) for k, m in metrics.items()},
                   grads=jax.device_get(grads))

    port = RAFTStereo(RAFTStereoConfig(**TINY), device="cpu")
    port.load_state_dict(variables_to_state_dict(v), strict=True)
    preds_t = port(torch.from_numpy(i1), torch.from_numpy(i2), iters=ITERS,
                   test_mode=False)
    loss_t, metrics_t = sequence_loss(preds_t, torch.from_numpy(gt),
                                      torch.from_numpy(valid))
    loss_t.backward()
    port_out = dict(loss=float(loss_t.detach()),
                    preds=preds_t.detach().numpy(),
                    metrics={k: float(m.detach())
                             for k, m in metrics_t.items()},
                    grads={k: p.grad.clone()
                           for k, p in port.named_parameters()})
    return v, jax_out, port_out


def test_train_predictions_match_jax(case):
    """Every iteration's full-resolution prediction.  The thresholds of
    the test-mode parity tests: fp32 rounding differences between two
    frameworks carried through three GRU iterations (O(100) px here)."""
    _, j, p = case
    assert p["preds"].shape == j["preds"].shape == (ITERS, 1) + HW + (1,)
    assert np.abs(j["preds"]).max() > 1.0  # a non-trivial comparison
    np.testing.assert_allclose(p["preds"], j["preds"], rtol=0, atol=5e-3)


def test_train_loss_and_metrics_match_jax(case):
    _, j, p = case
    # Means of O(50) px errors over ~1400 pixels, summed in another order.
    assert p["loss"] == pytest.approx(j["loss"], rel=1e-5)
    assert set(p["metrics"]) == set(j["metrics"]) == {"epe", "1px", "3px",
                                                      "5px"}
    for k in ("1px", "3px", "5px"):  # counts over the same pixels
        assert p["metrics"][k] == pytest.approx(j["metrics"][k], abs=1e-6)
    assert p["metrics"]["epe"] == pytest.approx(j["metrics"]["epe"], rel=1e-5)


def test_train_gradients_match_jax(case):
    """Every parameter's gradient within 1e-3 of the largest JAX gradient
    entry: fp32 reductions over ~10^4 terms per entry, reordered, carried
    back through three iterations (measured: ~2e-5 against a float64
    run of the port).  Biases ahead of an instance norm have a true
    gradient of zero; both frameworks give rounding noise there."""
    _, j, p = case
    gj = variables_to_state_dict({"params": j["grads"]})
    assert set(gj) == set(p["grads"])
    gmax = max(float(t.abs().max()) for t in gj.values())
    assert gmax > 1.0
    worst = {k: float((p["grads"][k] - gj[k]).abs().max()) for k in gj}
    bad = {k: e for k, e in worst.items() if e > 1e-3 * gmax}
    assert not bad, (gmax, bad)


def test_one_step_params_match_jax(case):
    """One clip + AdamW step from the same gradients' parameters, against
    optax's update of the JAX gradients: within 2x that step's learning
    rate (Adam's first step moves each entry by about lr, so a sign flip
    of a rounding-level gradient moves it by at most 2 lr).  A first Adam
    step cannot tell a clipped gradient from an unclipped one; the test
    below holds the step's clip, learning-rate index and Adam count."""
    v, j, p = case
    cfg = TrainConfig(batch_size=1, image_size=HW, train_iters=ITERS)
    tx, jschedule = jax_make_optimizer(JaxTrainConfig(batch_size=1))
    params = v["params"]
    new = jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(j["grads"], params)
    want = variables_to_state_dict({"params": jax.device_get(new)})

    port = RAFTStereo(RAFTStereoConfig(**TINY), device="cpu")
    port.load_state_dict(variables_to_state_dict(v), strict=True)
    opt, schedule = make_optimizer(cfg, dict(port.named_parameters()))
    state = TrainState(step=0, model=port, opt=opt)
    i1, i2, gt, valid = (torch.from_numpy(a) for a in _inputs())
    metrics = make_train_step(cfg, schedule)(state, (i1, i2, gt, valid))
    lr = float(jschedule(0))
    assert metrics["lr"] == lr and state.step == 1 and opt.count == 1
    assert metrics["loss"] == pytest.approx(j["loss"], rel=1e-5)
    for k, t in port.named_parameters():
        err = float((t.detach() - want[k]).abs().max())
        assert err <= 2 * lr, (k, err, lr)


def test_train_step_matches_optax_over_steps(monkeypatch):
    """Three ``make_train_step`` calls on different batches against optax's
    chain (clip, then AdamW with the schedule's own count) applied to the
    same raw gradients, which the step's ``global_norm`` call records.  The
    first step's learning rate is 1/25 of the second's and the gradient
    norms exceed the clip, so a missing clip, a wrong learning-rate index
    or a wrong Adam count moves the parameters far beyond the tolerance
    from step 2 on."""
    import raftstereo_tpu_torch.train.step as step_mod

    raw = []
    real_norm = step_mod.global_norm

    def recording_norm(grads):
        raw.append({k: g.detach().numpy().copy() for k, g in grads.items()})
        return real_norm(grads)

    monkeypatch.setattr(step_mod, "global_norm", recording_norm)
    kw = dict(lr=1e-2, wdecay=1e-3, num_steps=20, grad_clip=1.0)
    cfg = TrainConfig(batch_size=1, image_size=HW, train_iters=2, **kw)
    tx, jschedule = jax_make_optimizer(JaxTrainConfig(batch_size=1, **kw))
    port = RAFTStereo(RAFTStereoConfig(**LOOP), device="cpu", seed=2)
    jp = {k: p.detach().numpy().copy() for k, p in port.named_parameters()}
    jstate = tx.init(jp)
    opt, schedule = make_optimizer(cfg, dict(port.named_parameters()))
    state = TrainState(step=0, model=port, opt=opt)
    step = make_train_step(cfg, schedule)

    @jax.jit
    def optax_step(g, s, p):
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s

    rng = np.random.default_rng(9)
    norms = []
    for s in range(3):
        batch = (rng.uniform(0, 255, (1,) + HW + (3,)),
                 rng.uniform(0, 255, (1,) + HW + (3,)),
                 -rng.uniform(1, 20, (1,) + HW + (1,)), np.ones((1,) + HW))
        metrics = step(state, tuple(torch.from_numpy(a.astype(np.float32))
                                    for a in batch))
        assert metrics["lr"] == pytest.approx(float(jschedule(s)), rel=1e-6)
        norms.append(metrics["grad_norm"])
        jp, jstate = optax_step(raw[-1], jstate, jp)
        # Adam's direction is O(1) per entry; where two steps' gradients
        # nearly cancel in the first moment, fp32 rounding grows to ~1e-5
        # of it, so the absolute floor is 1e-4 of the step's lr.
        for k, t in port.named_parameters():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-4 * metrics["lr"],
                                       err_msg=f"step {s + 1}: {k}")
    assert len(raw) == 3 and state.step == 3 and opt.count == 3
    assert max(norms) > cfg.grad_clip, norms   # the clip took effect
    assert schedule(0) * 20 < schedule(1)      # the index matters


def test_onecycle_matches_jax():
    for max_lr, total in ((2e-4, 1100), (1e-3, 150)):
        ours, ref = onecycle_lr(max_lr, total), jax_onecycle_lr(max_lr, total)
        got = np.array([ours(s) for s in range(total + 1)], np.float32)
        want = np.asarray(jax.vmap(ref)(jnp.arange(total + 1)))
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_optimizer_matches_optax_over_steps():
    """Five AdamW steps with clipping and decay on random tensors, with a
    skipped step in the middle (the Adam count stays, the schedule
    moves), against optax."""
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (7,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    cfg = TrainConfig(lr=1e-2, wdecay=0.1, num_steps=20, grad_clip=1.0)
    tx, jschedule = jax_make_optimizer(JaxTrainConfig(lr=1e-2, wdecay=0.1,
                                                      num_steps=20))
    jp, jstate = p0, tx.init(p0)
    tp = {k: torch.from_numpy(a.copy()) for k, a in p0.items()}
    opt, schedule = make_optimizer(cfg, tp)
    from raftstereo_tpu_torch.train.optim import (clip_by_global_norm,
                                                   global_norm)
    for step in range(5):
        g = {k: (rng.normal(size=s) * (3.0 if step % 2 else 0.1))
             .astype(np.float32) for k, s in shapes.items()}
        if step == 2:  # skipped: only the schedule count advances
            _, new_state = tx.update(g, jstate, jp)
            _, jstate = merge_skipped_update(jnp.bool_(False), jp, jp,
                                             new_state, jstate)
            continue
        updates, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tg = {k: torch.from_numpy(a) for k, a in g.items()}
        opt.update(tp, clip_by_global_norm(tg, global_norm(tg), 1.0),
                   schedule(step))
    assert opt.count == 4
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------- loop

def _loop_cfg(tmp_path, **kw):
    base = dict(name="t", batch_size=1, num_steps=3, train_iters=2,
                image_size=HW, checkpoint_dir=str(tmp_path / "ckpt"),
                validation_frequency=100, seed=3)
    base.update(kw)
    return TrainConfig(**base)


def _run(tmp_path, dataset, **kw):
    return cli_train.train(RAFTStereoConfig(**LOOP), _loop_cfg(tmp_path, **kw),
                           dataset=dataset, num_workers=0, no_validation=True,
                           device="cpu", log_dir=str(tmp_path / "runs"))


class _Poisoned:
    """ShiftStereoDataset whose left images carry a NaN."""

    def __init__(self):
        self.base = tsyn.ShiftStereoDataset(n=1, hw=HW)

    def reseed(self, seed):
        pass

    def __len__(self):
        return 1

    def __getitem__(self, i):
        meta, a, b, flow, valid = self.base[i]
        a = a.copy()
        a[0, 0, 0] = np.nan
        return meta, a, b, flow, valid


def test_nan_policy_skip_keeps_params_and_moments(tmp_path):
    model = RAFTStereo(RAFTStereoConfig(**LOOP), device="cpu", seed=3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = _loop_cfg(tmp_path, nan_policy="skip")
    opt, schedule = make_optimizer(cfg, dict(model.named_parameters()))
    state = TrainState(step=5, model=model, opt=opt)
    _, a, b, flow, valid = _Poisoned()[0]
    batch = tuple(torch.from_numpy(x[None]) for x in (a, b, flow, valid))
    metrics = make_train_step(cfg, schedule)(state, batch)
    assert metrics["nonfinite"] == 1.0 and metrics["lr"] == schedule(5)
    assert state.step == 6 and opt.count == 0     # the schedule moved on
    for k, t in model.state_dict().items():
        assert torch.equal(t, before[k]), k
    assert all(float(m.abs().max()) == 0 for m in opt.mu.values())


def test_nan_policy_abort_raises_and_skip_completes(tmp_path):
    with pytest.raises(FloatingPointError, match="step 1"):
        _run(tmp_path / "a", _Poisoned(), nan_policy="abort")
    state = _run(tmp_path / "s", _Poisoned(), nan_policy="skip")
    assert state.step == 4 and state.opt.count == 0


def test_training_after_inference_in_one_process():
    """A test-mode forward (inference mode) first, then a train step at
    the same shapes: nothing cached while serving blocks the backward."""
    i1, i2, gt, valid = (torch.from_numpy(a) for a in _inputs())
    m = RAFTStereo(RAFTStereoConfig(gru_backend="xla", **LOOP),
                   device="cpu", seed=7)
    m(i1, i2, iters=2)
    loss, _ = sequence_loss(m(i1, i2, iters=2, test_mode=False), gt, valid)
    loss.backward()
    assert all(p.grad is not None for p in m.parameters())


def test_remat_gives_the_same_loss_and_gradients():
    i1, i2, gt, valid = (torch.from_numpy(a) for a in _inputs())
    out = []
    for remat in (False, True):
        m = RAFTStereo(RAFTStereoConfig(remat=remat, **LOOP), device="cpu",
                       seed=5)
        loss, _ = sequence_loss(m(i1, i2, iters=ITERS, test_mode=False), gt,
                                valid)
        loss.backward()
        out.append((loss.detach(), {k: p.grad for k, p in
                                    m.named_parameters()}))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for k in g0:  # the recomputed forward is the same arithmetic
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-7)


class _SignalAt:
    """One fixed sample; delivers SIGTERM to this process when sample
    ``at`` is fetched (with one sample per epoch, fetch k precedes step
    k), as a preemption would."""

    def __init__(self, at=None):
        self.base = tsyn.ShiftStereoDataset(n=1, hw=HW, seed=4)
        self.at, self.calls = at, 0

    def reseed(self, seed):
        pass

    def __len__(self):
        return 1

    def __getitem__(self, i):
        self.calls += 1
        if self.calls == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.base[i]


def test_sigterm_save_and_resume_is_bitwise(tmp_path):
    """2 steps, SIGTERM, boundary save; the relaunch resumes at step 2 and
    runs 2 more: bitwise the parameters and Adam state of 4 straight
    steps."""
    pre = _run(tmp_path / "a", _SignalAt(at=3), num_steps=3)
    assert pre.step == 2
    mngr = CheckpointManager(str(tmp_path / "a" / "ckpt" / "t"))
    assert mngr.all_steps() == [2]
    assert not (tmp_path / "a" / "ckpt" / "t" / "t-final.pt").exists()
    resumed = _run(tmp_path / "a", _SignalAt(), num_steps=3)
    straight = _run(tmp_path / "b", _SignalAt(), num_steps=3)
    assert resumed.step == straight.step == 4
    for (k, a), (_, b) in zip(resumed.model.state_dict().items(),
                              straight.model.state_dict().items()):
        assert torch.equal(a, b), k
    for k in straight.opt.mu:
        assert torch.equal(resumed.opt.mu[k], straight.opt.mu[k])
        assert torch.equal(resumed.opt.nu[k], straight.opt.nu[k])
    assert (tmp_path / "a" / "ckpt" / "t" / "t-final.pt").exists()


def test_restore_latest_valid_skips_a_corrupt_step(tmp_path):
    model = RAFTStereo(RAFTStereoConfig(**LOOP), device="cpu", seed=1)
    cfg = _loop_cfg(tmp_path)
    opt, _ = make_optimizer(cfg, dict(model.named_parameters()))
    state = TrainState(step=1, model=model, opt=opt)
    mngr = CheckpointManager(str(tmp_path / "c"), keep=2)
    for step in (1, 2, 3):
        state.step = step
        mngr.save(step, state)
    assert mngr.all_steps() == [2, 3]              # newest 2 retained
    with open(mngr.path(3), "r+b") as f:
        f.write(b"\0" * 64)                        # a torn newest step
    state.step = 0
    assert mngr.restore_latest_valid(state) == 2 and state.step == 2


@pytest.mark.parametrize("kw,item", [
    (dict(no_validation=False, dataset_root="missing"), None),
    (dict(metrics_port=0), "item 11"), (dict(profile_steps=(1, 2)), "item 11"),
    (dict(fault_plan="crash@step=1"), "item 11"),
    (dict(cfg=dict(data_parallel=2)), "item 10"),
    (dict(cfg=dict(device_photometric=True)), "item 3"),
    (dict(workload="sl"), "item 9")],
    ids=["validation", "metrics_port", "profile_steps", "faults",
         "data_parallel", "device_photometric", "workload_sl"])
def test_train_refuses_unported_options(tmp_path, kw, item):
    """Each option the port does not run is refused before any work; so
    is in-training validation without its FlyingThings3D TEST split (the
    validation case: a fail-fast ValueError, as in the JAX package)."""
    kw = dict(kw)
    cfg = _loop_cfg(tmp_path, **kw.pop("cfg", {}))
    args = dict(dataset=tsyn.ShiftStereoDataset(n=1, hw=HW), num_workers=0,
                no_validation=True, device="cpu")
    args.update(kw)
    if "dataset_root" in kw:
        args["dataset_root"] = str(tmp_path / kw["dataset_root"])
    exc, match = ((NotImplementedError, f"ROADMAP.md Queue 1 {item}") if item
                  else (ValueError, "FlyingThings3D TEST split"))
    with pytest.raises(exc, match=match):
        cli_train.train(RAFTStereoConfig(**LOOP), cfg, **args)
    assert not (tmp_path / "ckpt").exists()   # refused before any work


def test_train_defaults_to_cuda_and_refuses_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_train.train(RAFTStereoConfig(**LOOP), _loop_cfg(tmp_path),
                        dataset=tsyn.ShiftStereoDataset(n=1, hw=HW),
                        num_workers=0, no_validation=True)


def test_cli_main_trains_from_a_kitti_tree(tmp_path, monkeypatch):
    tsyn.make_learnable_kitti(tmp_path / "kitti", n=2, hw=(40, 56))
    monkeypatch.chdir(tmp_path)
    rc = cli_train.main([
        "--train_datasets", "kitti", "--dataset_root", str(tmp_path / "kitti"),
        "--batch_size", "1", "--image_size", "32", "48", "--train_iters", "2",
        "--num_steps", "1", "--no_validation", "--num_workers", "0",
        "--checkpoint_dir", str(tmp_path / "ck"), "--name", "k",
        "--device", "cpu", "--corr_levels", "2", "--corr_radius", "2",
        "--n_gru_layers", "2", "--hidden_dims", "16", "16"])
    assert rc == 0
    assert (tmp_path / "ck" / "k" / "2.pt").exists()
    assert (tmp_path / "ck" / "k" / "k-final.pt").exists()
    assert (tmp_path / "runs" / "k" / "metrics.jsonl").exists()


# ---------------------------------------------------------------- data

@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data") / "kitti"
    jsyn.make_learnable_kitti(root, n=4, hw=(48, 72),
                              rng=np.random.default_rng(0))
    return root


def test_learnable_kitti_trees_are_identical(tmp_path, kitti_root):
    tsyn.make_learnable_kitti(tmp_path / "k", n=4, hw=(48, 72),
                              rng=np.random.default_rng(0))
    for sub in ("image_2", "image_3", "disp_occ_0"):
        for name in sorted(os.listdir(kitti_root / "training" / sub)):
            a = (kitti_root / "training" / sub / name).read_bytes()
            assert a == (tmp_path / "k" / "training" / sub / name).read_bytes()


@pytest.mark.parametrize("aug", [
    dict(), dict(spatial_scale=(-0.2, 0.4), do_flip="h",
                 saturation_range=(0.0, 1.4), img_gamma=(0.8, 1.2))],
    ids=["default", "scale_flip_jitter"])
def test_kitti_reader_and_loader_match_jax(kitti_root, aug):
    """The copied reader, sparse augmentor and loader give the JAX
    package's batches bitwise for the same seed."""
    def build(mod, lmod):
        params = mod.build_aug_params((32, 48), **aug)
        ds = mod.fetch_dataset(["kitti"], params, {"kitti": str(kitti_root)})
        return lmod.DataLoader(ds, 2, shuffle=True, num_workers=0, seed=11)

    theirs, ours = build(jds, jloader), build(tds, tloader)
    for _ in range(2):  # two epochs: per-epoch shuffle and reseed
        for a, b in zip(theirs, ours, strict=True):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_shift_dataset_matches_jax():
    a, b = jsyn.ShiftStereoDataset(n=3, hw=HW, seed=2), \
        tsyn.ShiftStereoDataset(n=3, hw=HW, seed=2)
    for i in range(3):
        for x, y in zip(a[i][1:], b[i][1:]):
            np.testing.assert_array_equal(x, y)
