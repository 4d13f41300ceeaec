"""Benchmark validators, twins of the JAX package's
``raftstereo_tpu/eval/validate.py``: the same metric keys, masks and
aggregation (the reference's ``evaluate_stereo.py``):

* ETH3D — D1 at 1 px; EPE and D1 averaged per image;
* KITTI-2015 — D1 at 3 px; EPE per-image mean, D1 pooled over all valid
  pixels; ``kitti-fps`` from the calls after ``warmup`` images that did
  not include a first run at their padded shape;
* FlyingThings (TEST, finalpass) — D1 at 1 px, validity also requires
  |gt| < 192; D1 pooled over pixels;
* Middlebury F/H/Q — D1 at 2 px; validity is the reference's
  ``valid >= -0.5 & gt_flow > -1000``; per-image averages.

Each validator takes the model (which carries its weights) and an
optional pre-built dataset or evaluator.  The structured-light
validator is not ported.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from ..data import datasets as ds
from .runner import Evaluator

logger = logging.getLogger(__name__)


def _epe_map(pred: np.ndarray, flow_gt: np.ndarray) -> np.ndarray:
    """Per-pixel endpoint error of the x-flow (the y flow is zero on both
    sides)."""
    return np.abs(pred - flow_gt[..., 0])


def _unpack(sample):
    _, image1, image2, flow, valid = sample
    return image1, image2, flow, valid


def validate_eth3d(model, iters: int = 32, dataset=None,
                   root: Optional[str] = None,
                   evaluator: Optional[Evaluator] = None) -> Dict[str, float]:
    """ETH3D two-view training split."""
    if dataset is None:
        dataset = ds.ETH3D(aug_params=None, **({"root": root} if root else {}))
    run = evaluator or Evaluator(model, iters=iters)
    epe_list, out_list = [], []
    for i in range(len(dataset)):
        image1, image2, flow_gt, valid_gt = _unpack(dataset[i])
        epe = _epe_map(run(image1, image2), flow_gt).ravel()
        val = valid_gt.ravel() >= 0.5
        image_epe = float(epe[val].mean())
        image_out = float((epe[val] > 1.0).mean())
        logger.info("ETH3D %d/%d EPE %.4f D1 %.4f", i + 1, len(dataset),
                    image_epe, image_out)
        epe_list.append(image_epe)
        out_list.append(image_out)
    return {"eth3d-epe": float(np.mean(epe_list)),
            "eth3d-d1": 100 * float(np.mean(out_list))}


def validate_kitti(model, iters: int = 32, dataset=None,
                   root: Optional[str] = None,
                   evaluator: Optional[Evaluator] = None,
                   warmup: int = 50) -> Dict[str, float]:
    """KITTI-2015 training split."""
    if dataset is None:
        dataset = ds.KITTI(aug_params=None, image_set="training",
                           **({"root": root} if root else {}))
    run = evaluator or Evaluator(model, iters=iters)
    epe_list, out_list, elapsed = [], [], []
    for i in range(len(dataset)):
        image1, image2, flow_gt, valid_gt = _unpack(dataset[i])
        pred = run(image1, image2)
        if i > warmup and not run.last_included_compile:
            elapsed.append(run.last_runtime)
        epe = _epe_map(pred, flow_gt).ravel()
        val = valid_gt.ravel() >= 0.5
        image_epe = float(epe[val].mean())
        if i < 9 or (i + 1) % 10 == 0:
            logger.info("KITTI %d/%d EPE %.4f D1 %.4f (%.3fs)", i + 1,
                        len(dataset), image_epe,
                        float((epe[val] > 3.0).mean()), run.last_runtime)
        epe_list.append(image_epe)
        out_list.append(epe[val] > 3.0)
    result = {"kitti-epe": float(np.mean(epe_list)),
              "kitti-d1": 100 * float(np.mean(np.concatenate(out_list)))}
    if elapsed:
        result["kitti-fps"] = 1.0 / float(np.mean(elapsed))
    return result


def validate_things(model, iters: int = 32, dataset=None,
                    root: Optional[str] = None,
                    evaluator: Optional[Evaluator] = None,
                    max_images: Optional[int] = None) -> Dict[str, float]:
    """FlyingThings3D TEST split, finalpass: the in-training check."""
    if dataset is None:
        dataset = ds.SceneFlowDatasets(dstype="frames_finalpass",
                                       things_test=True,
                                       **({"root": root} if root else {}))
    run = evaluator or Evaluator(model, iters=iters)
    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    epe_list, out_list = [], []
    for i in range(n):
        image1, image2, flow_gt, valid_gt = _unpack(dataset[i])
        epe = _epe_map(run(image1, image2), flow_gt).ravel()
        val = ((valid_gt.ravel() >= 0.5)
               & (np.abs(flow_gt[..., 0]).ravel() < 192))
        epe_list.append(float(epe[val].mean()))
        out_list.append(epe[val] > 1.0)
    return {"things-epe": float(np.mean(epe_list)),
            "things-d1": 100 * float(np.mean(np.concatenate(out_list)))}


def validate_middlebury(model, iters: int = 32, split: str = "F",
                        dataset=None, root: Optional[str] = None,
                        evaluator: Optional[Evaluator] = None
                        ) -> Dict[str, float]:
    """Middlebury-V3 training split; ``valid >= -0.5`` holds for every
    pixel of the reader's 0/1 mask, so only ``gt > -1000`` filters (the
    reference's quirk, kept)."""
    if dataset is None:
        dataset = ds.Middlebury(aug_params=None, split=split,
                                **({"root": root} if root else {}))
    run = evaluator or Evaluator(model, iters=iters)
    epe_list, out_list = [], []
    for i in range(len(dataset)):
        image1, image2, flow_gt, valid_gt = _unpack(dataset[i])
        epe = _epe_map(run(image1, image2), flow_gt).ravel()
        val = (valid_gt.ravel() >= -0.5) & (flow_gt[..., 0].ravel() > -1000)
        image_epe = float(epe[val].mean())
        image_out = float((epe[val] > 2.0).mean())
        logger.info("Middlebury %d/%d EPE %.4f D1 %.4f", i + 1, len(dataset),
                    image_epe, image_out)
        epe_list.append(image_epe)
        out_list.append(image_out)
    return {f"middlebury{split}-epe": float(np.mean(epe_list)),
            f"middlebury{split}-d1": 100 * float(np.mean(out_list))}


def validate_sl(model, **kwargs) -> Dict[str, float]:
    raise NotImplementedError(
        "structured-light validation (validate_sl) is not ported yet; see "
        "ROADMAP.md Queue 1 item 9")


VALIDATORS = {
    "eth3d": validate_eth3d,
    "sl": validate_sl,
    "kitti": validate_kitti,
    "things": validate_things,
    "middlebury_F": lambda *a, **k: validate_middlebury(*a, split="F", **k),
    "middlebury_H": lambda *a, **k: validate_middlebury(*a, split="H", **k),
    "middlebury_Q": lambda *a, **k: validate_middlebury(*a, split="Q", **k),
}


def validate(name: str, model, **kwargs) -> Dict[str, float]:
    """Dispatch by benchmark name."""
    if name not in VALIDATORS:
        raise ValueError(f"unknown benchmark {name!r}; "
                         f"choices: {sorted(VALIDATORS)}")
    return VALIDATORS[name](model, **kwargs)
