"""Train the port's RAFT-Stereo.

    python -m raftstereo_tpu_torch.cli.train --name raft-stereo \
        --train_datasets sceneflow --dataset_root DATA --no_validation

The counterpart of the JAX package's ``cli/train.py`` on one device: the
same flags and the same loop, with torch checkpoints (``train.checkpoint``)
in place of Orbax.  ``train()`` runs on the card unless the caller passes
``device="cpu"``; ``dataset`` injection lets a caller train on in-memory
data (``data.synthetic.ShiftStereoDataset``).  Every
``validation_frequency`` steps it saves a checkpoint and validates on the
FlyingThings3D TEST split (``eval.validate_things``, at most 200 pairs);
the split is loaded once at startup, and a missing or empty split fails
the run before any work unless ``--no_validation`` is given.

Not ported yet, and refused at startup with ``NotImplementedError``:
``--metrics_port``, ``--profile_steps``, ``--faults``, ``--data_parallel``
> 1, ``--device_photometric`` and ``--workload sl``.
"""

from __future__ import annotations

import argparse
import collections
import logging
import os
import statistics
import sys
import time
from typing import Optional

import numpy as np

from ..config import CORR_IMPLEMENTATIONS, RAFTStereoConfig, TrainConfig
from ..data import datasets as ds
from ..data.datasets import build_aug_params, fetch_dataset
from ..data.loader import DataLoader, prefetch_to_device
from ..device import resolve_device
from ..eval import validate_things
from ..models import RAFTStereo
from ..train.checkpoint import (CheckpointManager, PreemptionGuard,
                                save_weights)
from ..train.logger import Logger
from ..train.optim import make_optimizer
from ..train.state import TrainState
from ..train.step import make_train_step
from .common import load_weights_any

logger = logging.getLogger(__name__)


def add_train_args(p: argparse.ArgumentParser) -> None:
    d = TrainConfig()
    g = p.add_argument_group("training")
    g.add_argument("--name", default=d.name)
    g.add_argument("--workload", choices=["passive", "sl"], default="passive",
                   help="'sl' (structured light) is not ported yet")
    g.add_argument("--restore_ckpt", default=None,
                   help="weights to start from: an upstream .pth, a "
                        "train.checkpoint.save_weights file or a "
                        "flattened JAX variables .npz")
    g.add_argument("--batch_size", type=int, default=d.batch_size)
    g.add_argument("--train_datasets", nargs="+",
                   default=list(d.train_datasets))
    g.add_argument("--lr", type=float, default=d.lr)
    g.add_argument("--num_steps", type=int, default=d.num_steps)
    g.add_argument("--image_size", type=int, nargs=2,
                   default=list(d.image_size))
    g.add_argument("--train_iters", type=int, default=d.train_iters)
    g.add_argument("--valid_iters", type=int, default=d.valid_iters)
    g.add_argument("--wdecay", type=float, default=d.wdecay)
    g.add_argument("--seed", type=int, default=d.seed)
    g.add_argument("--validation_frequency", type=int,
                   default=d.validation_frequency)
    g.add_argument("--checkpoint_dir", default=d.checkpoint_dir)
    g.add_argument("--dataset_root", default=None)
    g.add_argument("--data_parallel", type=int, default=None,
                   help="data-parallel devices; only 1 is ported")
    g.add_argument("--num_workers", type=int, default=None)
    g.add_argument("--no_validation", action="store_true",
                   help="skip the periodic FlyingThings validation")
    g.add_argument("--profile_steps", type=int, nargs=2, default=None,
                   metavar=("START", "STOP"), help="not ported yet")
    g.add_argument("--metrics_port", type=int, default=None,
                   help="not ported yet")
    g.add_argument("--nan_policy", choices=["abort", "skip"],
                   default=d.nan_policy)
    g.add_argument("--max_restarts", type=int, default=d.max_restarts)
    g.add_argument("--restart_backoff", type=float,
                   default=d.restart_backoff)
    g.add_argument("--sample_retries", type=int, default=d.sample_retries)
    g.add_argument("--quarantine_limit", type=int,
                   default=d.quarantine_limit)
    g.add_argument("--loader_timeout_s", type=float,
                   default=d.loader_timeout_s)
    g.add_argument("--watchdog_factor", type=float,
                   default=d.watchdog_factor)
    g.add_argument("--faults", default=None, help="not ported yet")
    g.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a GPU) or 'cpu'")
    a = p.add_argument_group("augmentation")
    a.add_argument("--img_gamma", type=float, nargs="+", default=None)
    a.add_argument("--saturation_range", type=float, nargs=2, default=None)
    a.add_argument("--do_flip", choices=["h", "v"], default=None)
    a.add_argument("--spatial_scale", type=float, nargs=2,
                   default=[0.0, 0.0])
    a.add_argument("--noyjitter", action="store_true")
    a.add_argument("--device_photometric", action="store_true",
                   help="not ported yet")
    m = p.add_argument_group("model (defaults: the flagship config)")
    mc = RAFTStereoConfig()
    m.add_argument("--corr_levels", type=int, default=mc.corr_levels)
    m.add_argument("--corr_radius", type=int, default=mc.corr_radius)
    m.add_argument("--n_downsample", type=int, default=mc.n_downsample)
    m.add_argument("--n_gru_layers", type=int, default=mc.n_gru_layers)
    m.add_argument("--hidden_dims", nargs="+", type=int,
                   default=list(mc.hidden_dims))
    m.add_argument("--context_norm", default=mc.context_norm)
    m.add_argument("--corr_implementation", default=mc.corr_implementation,
                   choices=CORR_IMPLEMENTATIONS,
                   help="correlation backend; 'auto' = the on-demand "
                        "lookup kernel (pallas_alt)")
    m.add_argument("--corr_quant", action="store_true",
                   help="int8 correlation volume in inference; training "
                        "builds the fp32 volume, as the JAX package does")
    m.add_argument("--remat", action="store_true",
                   help="recompute each GRU iteration in the backward pass")


def train_config_from_args(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(
        name=args.name, batch_size=args.batch_size,
        train_datasets=tuple(args.train_datasets), lr=args.lr,
        num_steps=args.num_steps, image_size=tuple(args.image_size),
        train_iters=args.train_iters, valid_iters=args.valid_iters,
        wdecay=args.wdecay, seed=args.seed,
        validation_frequency=args.validation_frequency,
        checkpoint_dir=args.checkpoint_dir, restore_ckpt=args.restore_ckpt,
        img_gamma=args.img_gamma, saturation_range=args.saturation_range,
        do_flip=args.do_flip, spatial_scale=tuple(args.spatial_scale),
        noyjitter=args.noyjitter, data_parallel=args.data_parallel,
        nan_policy=args.nan_policy, max_restarts=args.max_restarts,
        restart_backoff=args.restart_backoff,
        sample_retries=args.sample_retries,
        quarantine_limit=args.quarantine_limit,
        loader_timeout_s=args.loader_timeout_s,
        watchdog_factor=args.watchdog_factor,
        device_photometric=args.device_photometric)


def model_config_from_args(args: argparse.Namespace) -> RAFTStereoConfig:
    return RAFTStereoConfig(
        corr_levels=args.corr_levels, corr_radius=args.corr_radius,
        n_downsample=args.n_downsample, n_gru_layers=args.n_gru_layers,
        hidden_dims=tuple(args.hidden_dims), context_norm=args.context_norm,
        corr_implementation=args.corr_implementation,
        corr_quant=args.corr_quant, remat=args.remat)


def check_unported(cfg: TrainConfig, profile_steps, faults, metrics_port,
                   workload: str) -> None:
    """Raise ``NotImplementedError`` for every option the port does not
    run yet, before any work starts."""
    refused = []
    if metrics_port is not None or profile_steps or faults:
        refused.append("--metrics_port, --profile_steps and --faults: "
                       "ROADMAP.md Queue 1 item 11")
    if cfg.data_parallel not in (None, 1):
        refused.append(f"data_parallel={cfg.data_parallel}: ROADMAP.md "
                       f"Queue 1 item 10")
    if cfg.device_photometric:
        refused.append("--device_photometric: ROADMAP.md Queue 1 item 3")
    if workload != "passive":
        refused.append(f"--workload {workload}: ROADMAP.md Queue 1 item 9")
    if refused:
        raise NotImplementedError("not ported yet: " + "; ".join(refused))


def _things_test(dataset_root: Optional[str]):
    """The FlyingThings3D TEST split (finalpass) for in-training
    validation; raises ``ValueError`` when it is missing or empty."""
    try:
        val = ds.SceneFlowDatasets(
            aug_params=None, dstype="frames_finalpass", things_test=True,
            **({"root": dataset_root} if dataset_root else {}))
    except (AssertionError, OSError, ValueError) as e:
        raise ValueError(
            "in-training validation requires the FlyingThings3D TEST split "
            f"and it could not be loaded ({e}); fix the dataset root or "
            "pass --no_validation to opt out explicitly") from e
    if len(val) == 0:
        raise ValueError(
            "in-training validation dataset is empty (no FlyingThings3D "
            "TEST split under the dataset root); fix the dataset root or "
            "pass --no_validation to opt out explicitly")
    return val


def train(model_cfg: RAFTStereoConfig, cfg: TrainConfig, dataset=None,
          num_workers: Optional[int] = None, no_validation: bool = False,
          dataset_root: Optional[str] = None, profile_steps=None,
          fault_plan=None, metrics_port: Optional[int] = None,
          workload: str = "passive", device="cuda",
          log_dir: Optional[str] = None) -> TrainState:
    """The training loop; returns the final state.

    Resumes from the newest valid checkpoint under
    ``checkpoint_dir/name``, else starts from ``cfg.restore_ckpt``'s
    weights, else from a fresh init seeded by ``cfg.seed``.  Runs steps
    until the step count exceeds ``cfg.num_steps``, saving every
    ``validation_frequency`` steps; SIGTERM/SIGINT save at the next step
    boundary and return.  ``log_dir`` defaults to ``runs/<name>``."""
    check_unported(cfg, profile_steps, fault_plan, metrics_port, workload)
    dev = resolve_device(device)
    val_dataset = None if no_validation else _things_test(dataset_root)
    np.random.seed(cfg.seed)

    model = RAFTStereo(model_cfg, device=dev, seed=cfg.seed)
    opt, schedule = make_optimizer(cfg, dict(model.named_parameters()))
    state = TrainState(step=0, model=model, opt=opt)
    ckpt_dir = os.path.join(cfg.checkpoint_dir, cfg.name)
    manager = CheckpointManager(ckpt_dir, keep=cfg.keep_checkpoints)
    init_sd = {k: v.clone() for k, v in model.state_dict().items()}

    def init_state():
        """Latest VALID checkpoint > --restore_ckpt weights > fresh init.
        Also the recovery path after a crash (--max_restarts)."""
        model.load_state_dict(init_sd)
        state.opt, _ = make_optimizer(cfg, dict(model.named_parameters()))
        state.step = 0
        if manager.latest_step() is not None:
            step = manager.restore_latest_valid(state)
            if step is not None:
                if step != manager.latest_step():
                    logger.error(
                        "latest checkpoint (step %d) is corrupt; resumed "
                        "from retained step %d instead", manager.latest_step(),
                        step)
                logger.info("Resumed from step %d in %s", state.step,
                            ckpt_dir)
                return
            logger.error("every retained checkpoint in %s is corrupt — "
                         "falling back to %s", ckpt_dir,
                         cfg.restore_ckpt or "a fresh init")
        if cfg.restore_ckpt:
            load_weights_any(cfg.restore_ckpt, model)
            logger.info("Initialised weights from %s", cfg.restore_ckpt)

    init_state()
    logger.info("The model has %.2fM learnable parameters.",
                sum(p.numel() for p in model.parameters()) / 1e6)

    if dataset is None:
        aug = build_aug_params(cfg.image_size, cfg.spatial_scale,
                               cfg.noyjitter, cfg.saturation_range,
                               cfg.img_gamma, cfg.do_flip)
        roots = ({k: dataset_root for k in
                  ("sceneflow", "kitti", "middlebury", "sintel",
                   "falling_things", "tartanair")}
                 if dataset_root else None)
        dataset = fetch_dataset(cfg.train_datasets, aug, roots)
    loader = DataLoader(dataset, cfg.batch_size, shuffle=True, drop_last=True,
                        num_workers=num_workers, seed=cfg.seed,
                        sample_retries=cfg.sample_retries,
                        quarantine_limit=cfg.quarantine_limit,
                        batch_timeout=cfg.loader_timeout_s or None)
    logger.info("Train loader: %d samples, %d batches/epoch",
                len(dataset), len(loader))
    if len(loader) == 0:
        raise ValueError(
            f"empty train loader: {len(dataset)} samples < batch_size "
            f"{cfg.batch_size} (check --train_datasets/--dataset_root)")

    step_fn = make_train_step(cfg, schedule)
    metrics_logger = Logger(
        log_dir=log_dir or os.path.join("runs", cfg.name),
        total_steps=state.step)
    saved_steps = set()  # steps saved by this process

    def save_ckpt(step):
        manager.save(step, state)
        saved_steps.add(step)

    def maybe_validate():
        if val_dataset is None:
            return
        try:
            results = validate_things(model, iters=cfg.valid_iters,
                                      dataset=val_dataset, max_images=200)
        except Exception as e:  # noqa: BLE001 — counted, training goes on
            # Startup loaded the split, so this is a runtime failure: loud
            # and counted, not a silent skip.
            logger.exception("Validation FAILED (counted as "
                             "validation_skipped): %s", e)
            metrics_logger.push({"validation_skipped": 1.0})
            return
        metrics_logger.push({"validation_skipped": 0.0})
        logger.info("Validation: %s", results)
        metrics_logger.write_dict(results)

    step_times = collections.deque(maxlen=101)

    def watchdog(dt, total_steps):
        """Flag a step slower than ``watchdog_factor`` x the running
        median."""
        flagged = 0.0
        if (cfg.watchdog_factor > 0 and len(step_times) >= 5
                and dt > cfg.watchdog_factor * statistics.median(step_times)):
            flagged = 1.0
            logger.warning("step watchdog: step %d took %.2fs (> %gx the "
                           "running median %.3fs)", total_steps, dt,
                           cfg.watchdog_factor,
                           statistics.median(step_times))
        step_times.append(dt)
        return flagged

    def run_loop():
        """Returns True when preempted."""
        should_keep_training = state.step <= cfg.num_steps
        while should_keep_training:
            for batch in prefetch_to_device(loader, dev):
                if guard.requested:
                    if state.step not in saved_steps:
                        save_ckpt(state.step)
                    logger.warning("preemption: checkpoint at step %d "
                                   "written; exiting cleanly", state.step)
                    return True
                t0 = time.monotonic()
                metrics = step_fn(state, batch)  # ends in a device sync
                dt = time.monotonic() - t0
                logger.info("step %d: loss %.6g, %.3fs", state.step,
                            metrics["loss"], dt)
                metrics_logger.write_scalar("step_seconds", dt, state.step)
                health = loader.health_metrics()
                health["watchdog_slow"] = watchdog(dt, state.step)
                if metrics.pop("nonfinite") >= 0.5:
                    if cfg.nan_policy == "abort":
                        raise FloatingPointError(
                            f"non-finite loss/gradient at step {state.step}")
                    logger.warning("step %d: non-finite loss/gradient — "
                                   "update skipped", state.step)
                    metrics_logger.push({"skipped": 1.0, **health})
                else:
                    metrics["skipped"] = 0.0
                    metrics_logger.write_scalar("live_loss", metrics["loss"],
                                                state.step)
                    metrics_logger.write_scalar("lr", metrics["lr"],
                                                state.step)
                    metrics_logger.push({**metrics, **health})
                if state.step % cfg.validation_frequency == 0:
                    save_ckpt(state.step)
                    maybe_validate()
                if state.step > cfg.num_steps:
                    should_keep_training = False
                    break
            if len(loader) >= 10000 and state.step not in saved_steps:
                save_ckpt(state.step)
        return False

    preempted = False
    restarts_np = 0
    last_resume_step = state.step
    guard = PreemptionGuard().install()
    try:
        while True:
            try:
                preempted = run_loop()
                break
            except (KeyboardInterrupt, FloatingPointError,
                    NotImplementedError):
                raise
            except Exception as e:
                if cfg.max_restarts <= 0:
                    raise
                init_state()
                if state.step > last_resume_step:
                    restarts_np = 0
                    delay = min(cfg.restart_backoff, 60.0)
                else:
                    restarts_np += 1
                    if restarts_np > cfg.max_restarts:
                        raise
                    delay = min(cfg.restart_backoff * 2 ** (restarts_np - 1),
                                60.0)
                logger.warning("training loop failed (%s); restart %d/%d "
                               "without progress, resuming at step %d after "
                               "%.1fs backoff", e, restarts_np,
                               cfg.max_restarts, state.step, delay)
                last_resume_step = state.step
                time.sleep(delay)
    finally:
        guard.uninstall()
        metrics_logger.close()

    if not preempted:
        if state.step not in saved_steps:
            save_ckpt(state.step)
        final = os.path.join(ckpt_dir, f"{cfg.name}-final.pt")
        save_weights(final, model)
        logger.info("Saved final weights to %s", final)
    return state


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_train_args(p)
    args = p.parse_args(argv)
    train(model_config_from_args(args), train_config_from_args(args),
          num_workers=args.num_workers, no_validation=args.no_validation,
          dataset_root=args.dataset_root, profile_steps=args.profile_steps,
          fault_plan=args.faults, metrics_port=args.metrics_port,
          workload=args.workload, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
