"""Train state: step + model (weights and frozen batch-norm statistics) +
optimizer state.

The counterpart of the JAX package's ``train/state.py``.  Batch norm is
frozen from step 0, as in the reference recipe: running statistics are
buffers that training never changes; only the parameters are trained.
The whole state round-trips through ``train.checkpoint`` so a resume is
exact."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .optim import AdamW


@dataclasses.dataclass
class TrainState:
    step: int             # number of completed steps
    model: torch.nn.Module
    opt: AdamW

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def state_dict(self) -> Dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "opt": self.opt.state_dict()}

    def load_state_dict(self, sd: Dict) -> None:
        self.model.load_state_dict(sd["model"], strict=True)
        self.opt.load_state_dict(sd["opt"])
        self.step = int(sd["step"])

