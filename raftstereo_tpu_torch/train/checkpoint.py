"""Checkpoints of the full train state, with retention, and preemption.

The counterpart of the JAX package's ``train/checkpoint.py`` with torch
files in place of Orbax: ``<directory>/<step>.pt`` holds the step, the
model's state dict and the optimizer state, so a resume is exact.  A save
writes a temporary file and renames it over the target, so a reader never
sees a torn checkpoint; only the newest ``keep`` steps are retained;
``restore_latest_valid`` falls back to older steps when the newest does
not load.
"""

from __future__ import annotations

import logging
import os
import re
import signal
import time
from typing import Dict, List, Optional

import torch

from .state import TrainState

logger = logging.getLogger(__name__)

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Step-indexed checkpoints under ``directory``, newest ``keep``
    retained."""

    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_FILE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> None:
        """Write ``state`` as step ``step`` (replacing an existing file of
        that step), then drop all but the newest ``keep`` steps."""
        _atomic_save(state.state_dict(), self.path(step))
        for old in self.all_steps()[:-self.keep]:
            os.remove(self.path(old))

    def _load(self, step: int) -> Dict:
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)

    def restore_latest_valid(self, state: TrainState) -> Optional[int]:
        """Restore the newest step whose file loads, falling back to older
        steps when it is corrupt (a torn write, bit rot).  Returns the
        step, or None when no retained step loads (``state`` unchanged).
        A file that loads but does not fit the model raises: every
        retained step would fail the same way."""
        for step in reversed(self.all_steps()):
            try:
                sd = self._load(step)
            except Exception as e:  # noqa: BLE001 — any unreadable file
                logger.error("checkpoint step %d failed to load (%s: %s) — "
                             "falling back to the previous retained step",
                             step, type(e).__name__, e)
                continue
            state.load_state_dict(sd)
            return step
        return None


class PreemptionGuard:
    """SIGTERM/SIGINT -> request a checkpoint at the next step boundary.

    The handler only sets a flag; the train loop checks :attr:`requested`
    at each step boundary, saves, and returns, so the relaunch resumes at
    the exact step.  A second signal restores the previous handler and
    re-delivers, for an operator who means "stop now"."""

    def __init__(self):
        self._requested_at: Optional[float] = None
        self._prev = {}

    def install(self) -> "PreemptionGuard":
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, self._handle)
        except ValueError:
            # Not the main thread: signals go to the main thread anyway.
            logger.warning("PreemptionGuard: not on the main thread — "
                           "SIGTERM/SIGINT will not trigger a boundary save")
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev = {}

    def _handle(self, signum, frame):
        if self._requested_at is not None:   # second signal: stop now
            signal.signal(signum, self._prev.get(signum, signal.SIG_DFL))
            os.kill(os.getpid(), signum)
            return
        self._requested_at = time.monotonic()
        logger.warning("received signal %d: checkpointing at the next step "
                       "boundary and exiting (signal again to exit now)",
                       signum)

    @property
    def requested(self) -> bool:
        return self._requested_at is not None


def save_weights(path: str, model: torch.nn.Module) -> None:
    """Weights-only save (state dict: parameters and batch-norm
    statistics) for evaluation and serving."""
    _atomic_save(model.state_dict(), os.path.abspath(path))


def load_weights(path: str, model: torch.nn.Module) -> None:
    """Load a ``save_weights`` file into ``model`` (strict)."""
    sd = torch.load(os.path.abspath(path), map_location="cpu",
                    weights_only=True)
    model.load_state_dict(sd, strict=True)
