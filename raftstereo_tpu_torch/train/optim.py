"""Optimizer: AdamW + one-cycle learning rate + global-norm gradient clip.

The JAX package's recipe (``train/optim.py``): optax's
``chain(clip_by_global_norm(grad_clip), adamw(schedule, b1=0.9,
b2=0.999, eps=1e-8, weight_decay=wdecay))`` with the two-phase linear
one-cycle schedule over ``num_steps + 100`` steps.  optax's semantics
are kept where they differ from ``torch.optim.AdamW`` and
``clip_grad_norm_``:

* the clip is ``g`` when ``|g| < c``, else ``(g / |g|) * c`` (no
  ``+1e-6``);
* weight decay is added to the Adam direction before the learning rate
  scales it: ``p += -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``;
* the Adam bias correction counts applied updates (``AdamW.count``); the
  schedule counts steps, so a skipped step advances the schedule only;
* the bias corrections ``1 - b ** count`` are taken in fp32, from the
  fp32 ``b``, as optax takes them (in float64 the first step's
  ``1 - 0.999`` is 1.3e-5 larger, relative, and each update 6e-6
  larger).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..config import TrainConfig


def onecycle_lr(max_lr: float, total_steps: int, pct_start: float = 0.01,
                div_factor: float = 25.0, final_div_factor: float = 1e4
                ) -> Callable[[int], float]:
    """Two-phase linear one-cycle schedule with torch's OneCycleLR
    semantics, in float32 arithmetic like the JAX schedule.

    Phase 1 (steps 0 .. up_end): linear initial_lr -> max_lr, up_end =
    pct_start * total_steps - 1.  Phase 2: linear max_lr -> min_lr at
    total_steps - 1."""
    f32 = np.float32
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    up_end = pct_start * total_steps - 1.0
    down_span = (total_steps - 1.0) - up_end

    def schedule(count: int) -> float:
        s = f32(count)
        if up_end > 0:
            lr_up = f32(initial_lr) + f32(max_lr - initial_lr) * np.clip(
                s / f32(up_end), f32(0), f32(1))
        else:
            lr_up = f32(max_lr)
        lr_down = f32(max_lr) + f32(min_lr - max_lr) * np.clip(
            (s - f32(up_end)) / f32(down_span), f32(0), f32(1))
        return float(lr_up if s <= f32(up_end) else lr_down)

    return schedule


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient (a 0-dim tensor)."""
    return torch.sqrt(sum((g * g).sum() for g in grads.values()))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], norm: torch.Tensor,
                        max_norm: float) -> Dict[str, torch.Tensor]:
    """optax's rule: ``g`` when ``norm < max_norm``, else ``(g / norm) *
    max_norm``."""
    if bool(norm < max_norm):
        return grads
    return {k: (g / norm) * max_norm for k, g in grads.items()}


class AdamW:
    """optax ``adamw`` over named parameters, updated in place.

    State: ``count`` (applied updates, for the bias correction) and the
    moments ``mu`` / ``nu`` per parameter name."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], lr: float) -> None:
        """One update of ``params`` (in place) with learning rate ``lr``."""
        b1, b2 = self.b1, self.b2
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(b2) ** f32(self.count))
        for k, p in params.items():
            g = grads[k]
            mu = (1 - b1) * g + b1 * self.mu[k]
            nu = (1 - b2) * (g * g) + b2 * self.nu[k]
            self.mu[k], self.nu[k] = mu, nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.wd * p
            p.add_((-lr) * u)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, sd: Dict) -> None:
        self.count = int(sd["count"])
        for name in ("mu", "nu"):
            mine = getattr(self, name)
            if set(sd[name]) != set(mine):
                raise KeyError(f"optimizer {name} keys differ from the "
                               f"model's parameters")
            for k, v in sd[name].items():
                mine[k] = v.to(mine[k].device, mine[k].dtype).clone()


def make_optimizer(cfg: TrainConfig, params: Dict[str, torch.Tensor]
                   ) -> Tuple[AdamW, Callable[[int], float]]:
    """(optimizer, lr schedule) of the reference training recipe."""
    schedule = onecycle_lr(cfg.lr, cfg.num_steps + 100, pct_start=0.01)
    return (AdamW(params, b1=0.9, b2=0.999, eps=1e-8,
                  weight_decay=cfg.wdecay), schedule)
