"""Batch inference engine: bucket padding + the test-mode forward.

The counterpart of the JAX package's ``serve/engine.py`` ``BatchEngine``
for this slice: each pair is padded by ``ops.image.BucketPadder`` to its
shape bucket, the pairs of one bucket run as one batch through
``RAFTStereo.forward``, and the full-resolution disparities come back
unpadded.  The engine serialises dispatch under a lock (one model, one
device) and keeps per-bucket counts and times.
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
        self._lock = threading.Lock()
        # "HxW" -> {"batches", "pairs", "seconds"}
        self._stats: Dict[str, Dict[str, float]] = {}  # guarded_by: _lock

    def padder_of(self, shape: Sequence[int]) -> BucketPadder:
        return BucketPadder(shape, divis_by=self.cfg.divis_by,
                            bucket_multiple=self.cfg.bucket_multiple)

    def bucket_of(self, shape: Sequence[int]) -> Tuple[int, int]:
        return self.padder_of(shape).bucket_hw

    def infer_batch(self, pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                    iters: Optional[int] = None) -> List[np.ndarray]:
        """One batch; all pairs must fall in one bucket.  ``iters``
        defaults to ``serve_iters``."""
        if not pairs:
            raise ValueError("empty batch")
        iters = self.cfg.serve_iters if iters is None else int(iters)
        padders = [self.padder_of(p[0].shape) for p in pairs]
        hw = padders[0].bucket_hw
        if any(p.bucket_hw != hw for p in padders):
            raise ValueError("mixed buckets in one batch: "
                             f"{sorted({p.bucket_hw for p in padders})}")
        with self._lock:
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
            _, up = self.model(torch.cat(lefts), torch.cat(rights),
                               iters=iters)
            out = [padder.unpad(up[i:i + 1])[0, ..., 0].cpu().numpy()
                   for i, padder in enumerate(padders)]
            st = self._stats.setdefault(f"{hw[0]}x{hw[1]}", {
                "batches": 0, "pairs": 0, "seconds": 0.0})
            st["batches"] += 1
            st["pairs"] += len(pairs)
            st["seconds"] += time.perf_counter() - t0
        return out

    def warmup(self) -> List[Tuple[int, int]]:
        """Run one zero pair per configured bucket (first use builds the
        kernels); returns the buckets warmed."""
        warmed = []
        for h, w in self.cfg.buckets:
            zero = np.zeros((h, w, 3), np.float32)
            self.infer_batch([(zero, zero)])
            warmed.append(self.bucket_of((h, w)))
        return warmed

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per-bucket batches, pairs and total seconds (including the
        host copies)."""
        with self._lock:
            return {k: dict(v) for k, v in self._stats.items()}
