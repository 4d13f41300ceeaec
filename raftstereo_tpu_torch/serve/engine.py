"""Batch inference engine: bucket padding + the test-mode forward.

The counterpart of the JAX package's ``serve/engine.py`` ``BatchEngine``
for this slice: each pair is padded by ``ops.image.BucketPadder`` to its
shape bucket, the pairs of one bucket run as one batch through
``RAFTStereo.forward``, and the full-resolution disparities come back
unpadded.  The engine serialises dispatch under a lock (one device) and
keeps per-bucket counts and times.  A bf16 model
(``compute_dtype="bfloat16"``) serves the same fp32 images and returns
fp32 disparities.

Precision modes (``ops.quant``): a batch runs in the base model's own
mode (``mode=None``, the ``default_mode`` of its config) or in a tier's
("fp32", "bf16", "int8"), whose model is built on first use by
``RAFTStereo.with_numerics`` and shares the base model's parameter
tensors.  A request without a mode runs the base model unchanged.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ServeConfig
from ..device import resolve_device
from ..ops.image import BucketPadder
from ..ops.quant import MODES, config_for_mode, default_mode


class BatchEngine:
    """Runs bucketed batches of (left, right) pairs through ``model``.

    ``model`` must already be on ``device``.  Images are (H, W, 3) arrays
    in [0, 255]; ``infer_batch`` returns one (H, W) float32 disparity per
    pair."""

    def __init__(self, model, config: ServeConfig = ServeConfig(),
                 device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine device "
                             f"is {self.device}")
        self.model = model
        self.cfg = config
        self.default_mode = default_mode(model.config)
        self._lock = threading.Lock()
        # mode -> model; tier models are built on first use
        self._models = {self.default_mode: model}  # guarded_by: _lock
        # "HxW" (the default mode) or "HxW/mode" -> {"batches", "pairs",
        # "seconds"}
        self._stats: Dict[str, Dict[str, float]] = {}  # guarded_by: _lock

    def padder_of(self, shape: Sequence[int]) -> BucketPadder:
        return BucketPadder(shape, divis_by=self.cfg.divis_by,
                            bucket_multiple=self.cfg.bucket_multiple)

    def bucket_of(self, shape: Sequence[int]) -> Tuple[int, int]:
        return self.padder_of(shape).bucket_hw

    def model_for(self, mode: Optional[str] = None):
        """The model of precision mode ``mode`` (None: the base model's own
        mode); raises ``NotImplementedError`` where the port does not run
        the mode's numerics on this architecture."""
        with self._lock:
            return self._model_for(self._mode(mode))

    def _mode(self, mode: Optional[str]) -> str:
        if mode is None:
            return self.default_mode
        if mode != self.default_mode and mode not in MODES:
            raise ValueError(f"unknown precision mode {mode!r}; choose from "
                             f"{list(MODES)}")
        return mode

    def _model_for(self, mode: str):  # guarded_by: _lock
        model = self._models.get(mode)
        if model is None:
            model = self.model.with_numerics(
                config_for_mode(self.model.config, mode))
            self._models[mode] = model
        return model

    def infer_batch(self, pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                    iters: Optional[int] = None,
                    mode: Optional[str] = None) -> List[np.ndarray]:
        """One batch; all pairs must fall in one bucket.  ``iters``
        defaults to ``serve_iters``; ``mode`` to the base model's own."""
        if not pairs:
            raise ValueError("empty batch")
        iters = self.cfg.serve_iters if iters is None else int(iters)
        mode = self._mode(mode)
        padders = [self.padder_of(p[0].shape) for p in pairs]
        hw = padders[0].bucket_hw
        if any(p.bucket_hw != hw for p in padders):
            raise ValueError("mixed buckets in one batch: "
                             f"{sorted({p.bucket_hw for p in padders})}")
        with self._lock:
            model = self._model_for(mode)
            t0 = time.perf_counter()
            lefts, rights = [], []
            for (left, right), padder in zip(pairs, padders):
                l_t = torch.as_tensor(np.asarray(left, np.float32),
                                      device=self.device)[None]
                r_t = torch.as_tensor(np.asarray(right, np.float32),
                                      device=self.device)[None]
                l_t, r_t = padder.pad(l_t, r_t)
                lefts.append(l_t)
                rights.append(r_t)
            _, up = model(torch.cat(lefts), torch.cat(rights), iters=iters)
            out = [padder.unpad(up[i:i + 1])[0, ..., 0].cpu().numpy()
                   for i, padder in enumerate(padders)]
            key = f"{hw[0]}x{hw[1]}" + (
                "" if mode == self.default_mode else f"/{mode}")
            st = self._stats.setdefault(key, {
                "batches": 0, "pairs": 0, "seconds": 0.0})
            st["batches"] += 1
            st["pairs"] += len(pairs)
            st["seconds"] += time.perf_counter() - t0
        return out

    def warmup(self, modes: Optional[Sequence[Optional[str]]] = None
               ) -> List[Tuple[int, int, str]]:
        """Run one zero pair per configured bucket and mode (``modes``
        default: the base model's own; first use builds the kernels and
        the tier models); returns the (h, w, mode) warmed."""
        warmed = []
        for h, w in self.cfg.buckets:
            zero = np.zeros((h, w, 3), np.float32)
            for mode in [self._mode(m) for m in (modes or [None])]:
                self.infer_batch([(zero, zero)], mode=mode)
                warmed.append(self.bucket_of((h, w)) + (mode,))
        return warmed

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per bucket ("HxW") and tier mode ("HxW/mode"): batches, pairs
        and total seconds (including the host copies)."""
        with self._lock:
            return {k: dict(v) for k, v in self._stats.items()}
