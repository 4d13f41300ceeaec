"""The training step: loss, backward, global-norm clip, AdamW update.

The counterpart of the JAX package's ``train/step.py`` on one device.
``nan_policy="skip"`` keeps the parameters and the Adam moments (and the
Adam count) when the loss or the gradient norm is not finite, and still
advances the step and so the schedule; "abort" applies the update as
computed and leaves the raise to the loop, as the JAX package does.

Mixed precision (``compute_dtype="bfloat16"``) follows the JAX package's
policy: the parameters and the AdamW moments stay fp32 and each module
casts its parameters to bf16 at use, so their gradients come back fp32
through the casts; the predictions are fp32 and ``sequence_loss`` is
computed in fp32; there is no loss scaling, since bf16 has fp32's
exponent range (``raftstereo_tpu/train/optim.py``'s note).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from ..config import TrainConfig
from .loss import sequence_loss
from .optim import clip_by_global_norm, global_norm
from .state import TrainState

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def make_train_step(cfg: TrainConfig, schedule: Callable[[int], float]
                    ) -> Callable[[TrainState, Batch], Dict[str, float]]:
    """Build ``step(state, batch) -> metrics``; the state is updated in
    place.  ``batch`` is (img1, img2, disp_gt, valid) on the model's
    device; metrics are floats: loss, grad_norm, nonfinite, lr, epe, 1px,
    3px, 5px."""

    def step(state: TrainState, batch: Batch) -> Dict[str, float]:
        img1, img2, disp_gt, valid = batch
        model = state.model
        params = state.params()
        for p in params.values():
            p.grad = None
        preds = model(img1, img2, iters=cfg.train_iters, test_mode=False)
        loss, metrics = sequence_loss(preds, disp_gt, valid,
                                      loss_gamma=cfg.loss_gamma,
                                      max_flow=cfg.max_flow)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        norm = global_norm(grads)
        loss = loss.detach()
        finite = math.isfinite(float(loss)) and math.isfinite(float(norm))
        lr = schedule(state.step)
        if finite or cfg.nan_policy != "skip":
            grads = clip_by_global_norm(grads, norm, cfg.grad_clip)
            state.opt.update(params, grads, lr)
        for p in params.values():
            p.grad = None
        state.step += 1
        out = {k: float(v.detach()) for k, v in metrics.items()}
        out.update(loss=float(loss), grad_norm=float(norm),
                   nonfinite=0.0 if finite else 1.0, lr=lr)
        return out

    return step
