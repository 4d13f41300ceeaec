"""Sequence loss over per-iteration disparity predictions.

The JAX package's ``train/loss.py`` ``sequence_loss``, with the same
semantics:

* gamma is adjusted to ``loss_gamma ** (15 / (n_predictions - 1))`` so the
  weight profile does not depend on the iteration count;
* validity mask = ``(valid >= 0.5) & (|disp_gt| < max_flow)``;
* each iteration's L1 is a mean over the valid pixels only;
* metrics: masked EPE of the last prediction and the fraction of valid
  pixels under 1/3/5 px.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def sequence_loss(disp_preds: torch.Tensor, disp_gt: torch.Tensor,
                  valid: torch.Tensor, loss_gamma: float = 0.9,
                  max_flow: float = 700.0
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """gamma-weighted L1 over all iteration predictions.

    ``disp_preds`` (iters, B, H, W, 1), ``disp_gt`` (B, H, W, 1) (negative
    x-flow), ``valid`` (B, H, W).  Returns the scalar loss and a dict of
    scalar metrics (0-dim float32 tensors, on the predictions' device)."""
    n = disp_preds.shape[0]
    if n < 1:
        raise ValueError("no predictions")
    disp_gt = disp_gt.float()
    preds = disp_preds.float()

    mag = disp_gt[..., 0].abs()                           # (B, H, W)
    mask = (valid.float() >= 0.5) & (mag < max_flow)
    m = mask.float()[..., None]                           # (B, H, W, 1)
    denom = torch.clamp_min(m.sum(), 1.0)

    gamma = loss_gamma ** (15.0 / (n - 1)) if n > 1 else 1.0
    # The i-th prediction weighs gamma^(n-i-1): the last one weighs 1.
    weights = torch.pow(torch.tensor(gamma, dtype=torch.float32),
                        torch.arange(n - 1, -1, -1, dtype=torch.float32)
                        ).to(preds.device)
    abs_err = (preds - disp_gt[None]).abs()              # (iters, B, H, W, 1)
    per_iter = (abs_err * m[None]).sum(dim=(1, 2, 3, 4)) / denom
    loss = (weights * per_iter).sum()

    epe = (preds[-1, ..., 0] - disp_gt[..., 0]).abs()     # (B, H, W)
    m0 = m[..., 0]
    mden = torch.clamp_min(m0.sum(), 1.0)

    def frac_under(t):
        return ((epe < t).float() * m0).sum() / mden

    metrics = {"epe": (epe * m0).sum() / mden, "1px": frac_under(1.0),
               "3px": frac_under(3.0), "5px": frac_under(5.0)}
    return loss, metrics
