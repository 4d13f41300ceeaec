"""Where one served request's, or one training step's, device time goes.

    python -m raftstereo_tpu_torch.cli.profile [--fused_encoder]
        [--corr_implementation IMPL] [--corr_quant] [--gru_backend GRU]
        [--mixed_precision [--corr_dtype bfloat16]]
    python -m raftstereo_tpu_torch.cli.profile --train [--remat]
        [--fused_encoder] [--corr_implementation IMPL]
        [--mixed_precision [--corr_dtype bfloat16]]

Builds the flagship model with seeded weights on the card.  By default it
warms the engine at the 540x960 bucket and 32 iterations (the serving
path of ``chip_smoke.py``) and profiles one ``BatchEngine.infer_batch``
call (``--fused_encoder``: with the fused encoder stages,
``RAFTStereoConfig(fused_encoder=True)``; ``--corr_implementation`` and
``--corr_quant`` pick the correlation backend and the int8 volume,
``--gru_backend`` the GRU step, ``--mixed_precision`` and ``--corr_dtype``
bf16 serving); with
``--train`` it profiles one training step of the recipe (batch 6,
320x720, 16 iterations, ``train.step.make_train_step``) after one warm-up
step; ``--remat`` recomputes each iteration in the backward pass,
``--fused_encoder`` trains through the fused encoder stages and their
backward, and ``--mixed_precision`` (with ``--corr_dtype``) trains in
bf16.
Either way it prints one JSON line: the wall time, the summed device
time of the kernels, the device busy time
(the union of the kernels' intervals, so overlapping kernels count once)
and idle share (1 - busy / wall), the peak device memory over the
profiled call, and device time by kernel, grouped by the port's CUDA
sources (``enc_conv_tc`` (with the sums' reduction that ``enc_conv_wg``
shares), ``enc_conv_wg``, ``enc_conv``, ``enc_stats``, ``dual_sums`` (the
second kernel of ``enc_stats.cu``), ``enc_finish``, ``alt_corr``,
``alt_corr_epi``, ``alt_corr_bwd``, ``corr_vol``, ``corr_vol_bwd``,
``int8_volume``, ``gru_update``) and by cuDNN/cuBLAS convolutions and
products ("conv"), with the largest kernels overall and within "conv"
(which names the algorithms cuDNN picked).  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from ..config import CORR_IMPLEMENTATIONS, RAFTStereoConfig, ServeConfig
from ..models import RAFTStereo
from ..serve.engine import BatchEngine

# Kernel-name prefixes of each CUDA source (csrc/*.cu), then the library
# convolutions and matrix products.
_GROUPS = {"enc_conv_tc": ("enc_conv_tc_kernel", "enc_conv_tc_stats_kernel"),
           "enc_conv_wg": ("enc_conv_wg_kernel",),
           "enc_conv": ("enc_conv_stats_kernel", "stem7_tc_kernel",
                        "stem7_bf16_kernel"),
           "enc_stats": ("enc_plane_stats_kernel",),
           "dual_sums": ("enc_dual_sums_kernel",),
           "enc_finish": ("enc_finish_kernel",),
           "alt_corr": ("alt_corr_kernel", "alt_corr_bf16_kernel"),
           "alt_corr_epi": ("alt_corr_epi_kernel",
                            "alt_corr_epi_bf16_kernel"),
           "alt_corr_bwd": ("alt_corr_bwd_kernel",),
           "corr_vol": ("corr_vol_kernel",),
           "corr_vol_bwd": ("corr_vol_bwd_kernel",),
           "int8_volume": ("int8_volume_kernel",),
           "gru_update": ("gru_mma_conv_kernel", "gru_simt_conv_kernel",
                          "conv3x3_few_out_kernel", "pad_rows_kernel"),
           "conv": ("cudnn", "xmma", "conv", "gemm", "wgrad", "dgrad",
                    "fprop", "sgemm")}


def _group(name: str) -> str:
    for group, prefixes in _GROUPS.items():
        if any(p in name for p in prefixes):
            return group
    return "other"


HW, ITERS, TOP = (540, 960), 32, 12
TRAIN_BATCH, TRAIN_HW, TRAIN_ITERS = 6, (320, 720), 16


def _serve_call(fused_encoder: bool, corr_implementation: str,
                corr_quant: bool, gru_backend: str = "auto",
                mixed_precision: bool = False, corr_dtype: str = "float32"):
    h, w = HW
    compute = "bfloat16" if mixed_precision else "float32"
    cfg = RAFTStereoConfig(fused_encoder=True if fused_encoder else None,
                           corr_implementation=corr_implementation,
                           corr_quant=corr_quant, gru_backend=gru_backend,
                           compute_dtype=compute, corr_dtype=corr_dtype)
    model = RAFTStereo(cfg, device="cuda", seed=0)
    engine = BatchEngine(model, ServeConfig(buckets=(HW,), serve_iters=ITERS))
    engine.warmup()
    rng = np.random.default_rng(0)
    pair = tuple(rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
                 for _ in range(2))
    return lambda: engine.infer_batch([pair]), {
        "bucket": [h, w], "iters": ITERS, "fused_encoder": fused_encoder,
        "corr_implementation": corr_implementation, "corr_quant": corr_quant,
        "gru_backend": gru_backend, "compute_dtype": compute,
        "corr_dtype": corr_dtype}


def _train_call(remat: bool, corr_implementation: str,
                fused_encoder: bool, mixed_precision: bool = False,
                corr_dtype: str = "float32"):
    from ..config import TrainConfig
    from ..train.optim import make_optimizer
    from ..train.state import TrainState
    from ..train.step import make_train_step

    cfg = TrainConfig(batch_size=TRAIN_BATCH, image_size=TRAIN_HW,
                      train_iters=TRAIN_ITERS)
    compute = "bfloat16" if mixed_precision else "float32"
    model = RAFTStereo(RAFTStereoConfig(
        remat=remat, corr_implementation=corr_implementation,
        fused_encoder=True if fused_encoder else None,
        compute_dtype=compute, corr_dtype=corr_dtype),
        device="cuda", seed=0)
    opt, schedule = make_optimizer(cfg, dict(model.named_parameters()))
    state = TrainState(step=0, model=model, opt=opt)
    step = make_train_step(cfg, schedule)
    g = torch.Generator(device="cuda").manual_seed(0)
    shape = (TRAIN_BATCH,) + TRAIN_HW
    batch = (255 * torch.rand(shape + (3,), generator=g, device="cuda"),
             255 * torch.rand(shape + (3,), generator=g, device="cuda"),
             -30 * torch.rand(shape + (1,), generator=g, device="cuda"),
             torch.ones(shape, device="cuda"))
    return lambda: step(state, batch), {"batch": TRAIN_BATCH,
                                        "image_hw": list(TRAIN_HW),
                                        "iters": TRAIN_ITERS,
                                        "remat": remat,
                                        "fused_encoder": fused_encoder,
                                        "corr_implementation":
                                            corr_implementation,
                                        "compute_dtype": compute,
                                        "corr_dtype": corr_dtype}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m raftstereo_tpu_torch.cli.profile",
        description="Device time of one served request or train step.")
    p.add_argument("--train", action="store_true",
                   help="profile one training step instead of a request")
    p.add_argument("--fused_encoder", action="store_true",
                   help="run the fused encoder stages")
    p.add_argument("--remat", action="store_true",
                   help="with --train: recompute each iteration in the "
                        "backward pass")
    p.add_argument("--corr_implementation", choices=CORR_IMPLEMENTATIONS,
                   default="auto", help="correlation backend")
    p.add_argument("--corr_quant", action="store_true",
                   help="serve with the int8 correlation volume")
    p.add_argument("--gru_backend", choices=["auto", "fused", "xla"],
                   default="auto", help="test-mode GRU step")
    p.add_argument("--mixed_precision", action="store_true",
                   help="serve or train in bf16 (compute_dtype='bfloat16')")
    p.add_argument("--corr_dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="storage dtype of the lookup's feature maps")
    args = p.parse_args(argv)
    if args.remat and not args.train:
        p.error("--remat needs --train")
    if args.corr_quant and args.train:
        p.error("--corr_quant serves only: training builds the fp32 volume")
    if args.train and args.gru_backend != "auto":
        p.error("--gru_backend is a serving option: training always takes "
                "the module step")
    train = args.train
    call, what = (_train_call(args.remat, args.corr_implementation,
                              args.fused_encoder, args.mixed_precision,
                              args.corr_dtype) if train
                  else _serve_call(args.fused_encoder,
                                   args.corr_implementation, args.corr_quant,
                                   args.gru_backend, args.mixed_precision,
                                   args.corr_dtype))
    call()  # warm-up: kernel builds, cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = defaultdict(lambda: [0.0, 0])
    spans = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = by_kernel[ev.name]
            k[0] += ev.device_time_total / 1e3
            k[1] += 1
            spans.append((ev.time_range.start, ev.time_range.end))
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    by_group = defaultdict(float)
    for name, (ms, _) in by_kernel.items():
        by_group[_group(name)] += ms
    device_ms = sum(v[0] for v in by_kernel.values())
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    top = ranked[:TOP]
    top_conv = [kv for kv in ranked if _group(kv[0]) == "conv"][:TOP]
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "path": "train_step" if train else "serve_request", **what,
        "wall_ms": wall_ms,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "device_ms": device_ms,
        "busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / 1e3 / wall_ms if wall_ms else None,
        "by_group_ms": dict(by_group),
        "top_kernels": [{"name": n[:80], "ms": ms, "count": c}
                        for n, (ms, c) in top],
        "top_conv_kernels": [{"name": n[:120], "ms": ms, "count": c}
                             for n, (ms, c) in top_conv]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
