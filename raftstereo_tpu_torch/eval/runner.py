"""Inference runner for evaluation and the demo: the twin of the JAX
package's ``raftstereo_tpu/eval/runner.py`` ``Evaluator``.

Each pair is padded by ``ops.image.BucketPadder`` (``divis_by``, an
optional coarser ``bucket_multiple``), run through the model's test-mode
forward and unpadded: the same shape policy as the serving engine
(``serve/engine.py``), so their outputs agree bitwise at equal shapes.
``batch_pad`` zero-pads the batch axis to the engine's padded batch.

Here the first call at a padded shape is the "compile": it pays cuDNN's
algorithm choice and the caching allocator's growth for that shape.  The
counters keep the JAX names (``cache_stats``, ``last_included_compile``)
so that ``kitti-fps`` drops those calls as it drops XLA compiles.  The
runtime spans the forward and the host fetch of the output, the point
where the card has finished.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Set, Tuple

import numpy as np
import torch

from ..ops.image import BucketPadder
from ..utils.profiling import LatencyHistogram


class Evaluator:
    """(H, W, 3) numpy image pair -> (H, W) float32 x-flow field.

    Predictions follow the dataset sign convention (negative disparity),
    so they compare directly against the ``flow`` channel of the data
    layer.  ``model`` carries the weights and the device; ``mesh`` (the
    JAX package's spatial sharding) is not ported."""

    def __init__(self, model, iters: int = 32, divis_by: int = 32,
                 bucket_multiple: Optional[int] = None,
                 batch_pad: Optional[int] = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "Evaluator(mesh=...) (spatial sharding over several "
                "devices) is not ported yet; see ROADMAP.md Queue 1 item 10")
        self.model = model
        self.iters = iters
        self.divis_by = divis_by
        self.bucket_multiple = bucket_multiple
        self.batch_pad = batch_pad
        self.compiled_shapes: Set[Tuple[int, int]] = set()
        self.cache_hits = 0
        self.cache_misses = 0
        self.latency = LatencyHistogram()
        self.last_runtime = float("nan")
        self.last_included_compile = True

    @property
    def cache_stats(self) -> Dict[str, int]:
        """One miss per padded shape ever run, a hit for every other call."""
        return {"hits": self.cache_hits, "misses": self.cache_misses,
                "shapes": len(self.compiled_shapes)}

    def pad(self, image1: np.ndarray, image2: np.ndarray):
        """The padded (B, H, W, 3) pair on the model's device, as the
        forward sees it, and its padder."""
        if image1.ndim == 3:
            image1, image2 = image1[None], image2[None]
        if image1.shape[0] != 1:
            raise ValueError(f"Evaluator is single-pair; got batch "
                             f"{image1.shape[0]}")
        padder = BucketPadder(image1.shape, divis_by=self.divis_by,
                              bucket_multiple=self.bucket_multiple)
        dev = self.model.device
        i1, i2 = padder.pad(
            torch.as_tensor(np.asarray(image1, np.float32), device=dev),
            torch.as_tensor(np.asarray(image2, np.float32), device=dev))
        if self.batch_pad and self.batch_pad > 1:
            rows = self.batch_pad - 1
            i1, i2 = (torch.cat([t, t.new_zeros((rows,) + t.shape[1:])])
                      for t in (i1, i2))
        return i1, i2, padder

    def __call__(self, image1: np.ndarray, image2: np.ndarray) -> np.ndarray:
        i1, i2, padder = self.pad(image1, image2)
        shape = tuple(i1.shape[1:3])
        self.last_included_compile = shape not in self.compiled_shapes
        if self.last_included_compile:
            self.cache_misses += 1
        else:
            self.cache_hits += 1
        start = time.perf_counter()
        _, flow_up = self.model(i1, i2, iters=self.iters)
        flow_up = flow_up.cpu()  # host fetch = completion
        self.last_runtime = time.perf_counter() - start
        self.latency.observe(self.last_runtime)
        self.compiled_shapes.add(shape)
        return padder.unpad(flow_up)[0, ..., 0].numpy()
