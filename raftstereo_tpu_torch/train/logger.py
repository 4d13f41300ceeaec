"""Training metrics: running-mean console prints + TensorBoard + JSONL.

The JAX package's ``train/logger.py``: running means over ``SUM_FREQ=100``
steps and per-batch live loss / lr scalars, plus each step's wall time
(``step_seconds``; validation results come with the validator, which is
not ported yet).  TensorBoard goes through
``torch.utils.tensorboard`` when it is installed; a JSONL stream,
``<log_dir>/metrics.jsonl``, is always written so metrics survive without
it.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

SUM_FREQ = 100

logger = logging.getLogger(__name__)


def _make_tb_writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(log_dir=log_dir)
    except ImportError:  # tensorboard not installed — JSONL still covers it
        return None


class Logger:
    def __init__(self, log_dir: str = "runs", total_steps: int = 0):
        self.total_steps = total_steps
        self._window = 0
        self.running: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self.log_dir = log_dir
        self.writer = _make_tb_writer(log_dir)
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._t0 = time.time()

    # -- per-step -----------------------------------------------------------

    def push(self, metrics: Dict[str, float]) -> None:
        """Accumulate one step's metrics; print running means every SUM_FREQ
        steps."""
        self.total_steps += 1
        self._window += 1
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
            self._counts[k] = self._counts.get(k, 0) + 1
        if self.total_steps % SUM_FREQ == 0:
            # Per-key divisor: not every step pushes every key (a resume
            # starts mid-window; nan_policy=skip steps push only 'skipped'),
            # and dividing a key by pushes it did not appear in would dilute
            # its mean exactly when it matters.
            means = {k: v / self._counts[k] for k, v in self.running.items()}
            rate = self._window / max(time.time() - self._t0, 1e-9)
            self._window = 0
            self._t0 = time.time()
            keys = sorted(means)
            msg = f"[{self.total_steps:6d}] " + ", ".join(
                f"{k}={means[k]:10.4f}" for k in keys)
            logger.info("%s  (%.2f it/s)", msg, rate)
            self._emit({"step": self.total_steps, "steps_per_sec": rate,
                        **means})
            if self.writer is not None:
                for k, v in means.items():
                    self.writer.add_scalar(k, v, self.total_steps)
            self.running = {}
            self._counts = {}

    def write_scalar(self, name: str, value: float,
                     step: Optional[int] = None) -> None:
        """Per-batch scalar (live_loss / lr); always lands in the JSONL
        stream, not just TensorBoard."""
        step = self.total_steps if step is None else step
        self._emit({"step": step, name: float(value)})
        if self.writer is not None:
            self.writer.add_scalar(name, float(value), step)

    def write_dict(self, results: Dict[str, float]) -> None:
        """Validation results, at the current step."""
        self._emit({"step": self.total_steps,
                    **{k: float(v) for k, v in results.items()}})
        if self.writer is not None:
            for k, v in results.items():
                self.writer.add_scalar(k, float(v), self.total_steps)

    # -- internals ----------------------------------------------------------

    def _emit(self, record: Dict) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        # Flush the partial window: short runs (and the tail of long ones)
        # would otherwise lose up to SUM_FREQ-1 steps of metrics.
        if self._counts:
            means = {k: v / self._counts[k] for k, v in self.running.items()}
            self._emit({"step": self.total_steps, **means})
            self.running = {}
            self._counts = {}
        if self.writer is not None:
            self.writer.close()
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
