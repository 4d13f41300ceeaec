"""Where one served request's device time goes.

    python -m raftstereo_tpu_torch.cli.profile

Builds the flagship model with seeded weights on the card, warms the
engine at the 540x960 bucket and 32 iterations (the serving path of
``chip_smoke.py``), then runs one ``BatchEngine.infer_batch`` call under
``torch.profiler`` and prints one JSON line: the request's wall time, the
summed device time of its kernels, the device idle share (1 - device /
wall), and device time by kernel, with the port's two CUDA kernels
(``alt_corr``, ``gru_update``) grouped by their source.  Needs a GPU.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from ..config import RAFTStereoConfig, ServeConfig
from ..models import RAFTStereo
from ..serve.engine import BatchEngine

# Kernel-name prefixes of each CUDA source (csrc/*.cu).
_GROUPS = {"alt_corr": ("alt_corr_kernel",),
           "gru_update": ("conv_nhwc_kernel", "reset_gate_kernel",
                          "conv3x3_few_out_kernel")}


def _group(name: str) -> str:
    for group, prefixes in _GROUPS.items():
        if any(p in name for p in prefixes):
            return group
    return "other"


HW, ITERS, TOP = (540, 960), 32, 12


def main() -> int:
    h, w = HW
    model = RAFTStereo(RAFTStereoConfig(), device="cuda", seed=0)
    engine = BatchEngine(model, ServeConfig(buckets=(HW,), serve_iters=ITERS))
    engine.warmup()
    rng = np.random.default_rng(0)
    pair = tuple(rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
                 for _ in range(2))
    engine.infer_batch([pair])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.infer_batch([pair])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = by_kernel[ev.name]
            k[0] += ev.device_time_total / 1e3
            k[1] += 1
    by_group = defaultdict(float)
    for name, (ms, _) in by_kernel.items():
        by_group[_group(name)] += ms
    device_ms = sum(v[0] for v in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "bucket": [h, w],
        "iters": ITERS, "wall_ms": wall_ms,
        "device_ms": device_ms,
        "idle_share": 1.0 - device_ms / wall_ms if wall_ms else None,
        "by_group_ms": dict(by_group),
        "top_kernels": [{"name": n[:80], "ms": ms, "count": c}
                        for n, (ms, c) in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
