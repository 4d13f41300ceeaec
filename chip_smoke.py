#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, none caught: (1) print the card's name and power limit; (2) build
the CUDA kernels from ``raftstereo_tpu_torch/csrc``, printing ptxas's
registers, shared memory and spills of each tensor-core kernel (row 2's
fused update, ``gru_update.cu``; rows 9, 15 and 16's encoder convs,
``enc_conv_tc.cu``) and, where ``cuobjdump`` exists, the count of
tensor-core instructions (HMMA/HGMMA) in each library, which must not be
0; (3) hold each kernel against its plain PyTorch version on the card
at the shapes its main path gives it, and time both (the tensor-core
kernels' ``bound_ms`` is their 3xTF32 tensor-core bound, also
``bound_tc_ms``, with ``bound_cuda_core_ms`` beside it; the update also
as a ratio to its plain version's time): the serving path's lookup and
fused update (a 540x960 request pads to the 576x960 bucket, so the
1/4-resolution grid is 144x240 with C=256 and hidden 128), the training
path's lookup and its
backward (batch 6 of 320x720 crops: 480 rows of 180 pixels, C=256), the
lookup also on a smooth disparity field (its own ``serve_smooth`` row)
and, held only, on jumps wider than its staging buffer (its wide-span
path), the backward also with infinite cotangents (NaN and +-inf exactly
where plain has them), and
the fused encoder stages' kernels at the fused serving path's shapes
(fnet's 2 images and cnet's 1 at 576x960, layer2 at 288x480), the
stride-2 conv1 at the ``n_downsample=3`` shape and the stats kernel at a
batch-3 fnet shape (6 images); the backward and the encoder kernels also
bitwise repeatable; (4) serve three 540x960, 32-iteration requests of the
flagship model through ``/predict``, check that they are finite, bitwise
equal to a direct ``BatchEngine.infer_batch`` call, and that each serving
kernel launched exactly 32 times per request (and no encoder kernel);
(5) the same with ``fused_encoder=True``, whose encoder kernels must
launch exactly their per-request counts; (6) hold the card's forward
against the port's CPU forward (plain versions) on a small pair, plain
and fused encoders; (7) train the flagship model through
``cli.train.train`` on ``ShiftStereoDataset`` at the recipe shape (batch
6, 320x720, 16 iterations): 6 steps, then a second call that resumes from
the step-6 checkpoint and runs to step 8; every loss finite, the lookup
forward and backward kernels launched exactly 16 times per step each;
(8) hold one train step's loss and gradients on the card against the CPU
(plain versions) on a 64x96 pair; then the precomputed-volume
correlation: (9) hold its kernels against their plain versions, bitwise,
at the serving shape (the 144x240 volume pyramid, level widths
240/120/60/30; the int8 volume of 1x144x240 features, C=256) and the
training shape (6x80x180): the volume lookup, its backward (also two
calls bitwise equal, and on NaN and far coordinates and +-inf and NaN
cotangents) and the int8 volume, the lookup beside its library
call (``F.grid_sample``, 4 calls, one per level, as upstream
RAFT-Stereo's ``bilinear_sampler``) and the backward beside their
autograd backward; (10) serve three requests with
``corr_implementation="pallas"`` and the fused update, and three with
``corr_quant=True``: finite, bitwise equal to direct engine calls, 32
volume lookups and 32 updates per request, one int8 volume per quant
request, no on-demand lookup; (11) hold the card's forward against the
CPU's for ``pallas``, ``corr_quant``, ``reg`` and ``alt``; (12) train 3
steps of the recipe with ``pallas``, 16 lookups and 16 backward lookups
per step, and one 64x96 step card vs CPU; then training through the
fused encoder stages: (13) hold the kernels that path launches against
their plain versions at its shapes (fnet's 12 images of 320x720), the
instance-norm backward's dual sums among them, bitwise repeatable; (14)
train 3 steps of the recipe with ``fused_encoder=True``, every counted
kernel at its exact per-step launches (``FUSED_PER_STEP`` and the
lookup pair), step wall times and peak memory beside the plain
training path's; (15) one 64x96 fused step card vs CPU (the conv1-stage
backward).  Every training phase also checks that no kernel off its path
launched.  Then bf16 serving (``compute_dtype="bfloat16"``, the JAX
package's ``--mixed_precision``): (16) hold the bf16 forms of the lookup
and the fused update and the lookup with convc1 fused in (bf16 feature
maps, the serving shapes) against their plain versions, in bf16 ulps;
(17) serve three requests with bf16 compute and bf16 feature maps through
the fused update (32 bf16 lookups and 32 bf16 updates per request) and
three through the module step (32 fused-convc1 lookups per request, no
other counted kernel), replies bitwise equal to direct engine calls;
(18) hold each bf16 path's card forward against the CPU's with the card's
encoder outputs pinned.  Then the op functions and evaluation: (19) hold
the lookup at caller-given taps (row 3, at the serving pyramid and the
training shape in fp32, and in bf16), its general-taps backward (row 4,
bitwise repeatable) and the stand-alone instance norm (row 8, fp32 at a
576x960 bucket's fnet norm and at the training shape, bf16; relu on and
off) against their plain versions, timed; (20) run the op path: each
``pallas_alt_pyramid_flat`` forward and backward launches exactly one
row 3 and one row 4 kernel, each ``instance_norm_act`` forward and
backward one stats and one apply kernel, and gradients match the CPU's
on a small shape; (21) evaluate the flagship at full width on a
synthetic KITTI tree of 10 pairs at 375x1242, first through the
``Evaluator`` at a padded shape (384x1248) that the process has not run
yet (each output bitwise equal to a direct forward on the padded pair;
32 lookups and 32 updates per pair, no other kernel; the first call's
wall apart from the others'; ``kitti-fps``), then through
``cli.evaluate`` from a ``save_weights`` file and from an upstream-named
``.pth`` (equal finite EPE and D1, the Evaluator's EPE; the same
launches), and through ``cli.demo`` on 2 pairs (the ``.npy`` equal to
the Evaluator's output) and once ``--tiled`` (6 tiles, finite); (22)
hold the lookup and the fused update against their plain versions at the
evaluation grid (96x312, pyramid widths 312/156/78/39), timed.  Prints
a ``{"kernels": [...]}`` line, one row per kernel and path (the path's
launches beside the times and bound at its shapes), and, last,
``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, without a GPU or without the repo.
"""

from __future__ import annotations

import base64
import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np

# H100 SXM data sheet: HBM rate, fp32 rate outside the tensor cores (TF32
# is off on the port's fp32 path), the dense bf16 and int8 tensor-core
# rates.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_TF32_FLOP_PER_S = 495e12  # one TF32 pass; fp32 as 3xTF32 takes three
PEAK_INT8_OPS_PER_S = 1979e12
SLEEP_CYCLES = 20_000_000  # ~10 ms at the card's clock: time_ms's stream hold
CARD = "card not read yet"  # nvidia-smi's name and power limit, set by main

ITERS = 32
REQUESTS = 3
IMAGE_HW = (540, 960)
LOOKUP_TOL = 1e-4      # abs: fp32 dots of length 256, summed in another order
UPDATE_TOL = 1e-4      # relative to max(1, |plain|): fp32 conv sums, reordered
FORWARD_TOL = (2e-3, 5e-3)  # relative low-res / full-res, 4 GRU iterations
BACKWARD_TOL = 1e-4    # relative to max(1, |plain|): sums of ~40-200 fp32
#                        products of O(1) terms, in another order
TRAIN_BATCH, TRAIN_HW, TRAIN_ITERS = 6, (320, 720), 16
TRAIN_STEPS, RESUME_TO = 6, 8
STEP_LOSS_TOL = 1e-4   # relative: one train step's loss, card vs CPU
STEP_GRAD_TOL = 1e-3   # of the largest CPU gradient entry, card vs CPU
ENC_TOL = 1e-4         # relative to max(1, |plain|): fp32 conv sums of up
#                        to 576 products against cuDNN's order; output
#                        sums compared per pixel (divided by H*W)
FINISH_TOL = 1e-5      # relative: elementwise, FMAs where plain rounds twice
DUAL_TOL = 1e-5        # relative to max(1, |plain|), per-pixel means: fp32
#                        sums of 230,400 terms per plane in another order
# Per-request launches of the fused encoder kernels (fnet + cnet, one
# each per stage call): conv1, the four layer1 convs, the finish, the
# layer2 entry, its three convs and its finish; 0 for the stride-2 conv1
# and the stats kernel at batch 1.
FUSED_PER_REQUEST = {"stem_conv7": 2, "stem_conv7_s2": 0, "stage_conv": 8,
                     "plane_stats": 0, "stage_finish": 2, "l2_entry": 2,
                     "l2_conv": 6, "l2_finish": 2}
# Per-step launches of the fused encoder kernels on the training path at
# the recipe (fnet 12 images, cnet 6: more than the fused conv1 takes, so
# conv1 runs in cuDNN, fnet's stage takes its first sums from the stats
# kernel, and the instance-norm stage backward takes its five dual sums,
# for dc21, dc20, dc11, dc10 and dy1; cnet's frozen-BN backward takes none).
FUSED_STEPS = 3
FUSED_PER_STEP = {"stage_conv": 8, "plane_stats": 1, "stage_finish": 2,
                  "l2_entry": 2, "l2_conv": 6, "l2_finish": 2,
                  "dual_sums": 5}
# The volume kernels are held bitwise against their plain versions: both
# round each product and each sum once, in the same order, and the int8
# product is exact.
VOL_STEPS = 3          # training steps with corr_implementation="pallas"
# bf16 kernels against their plain versions, in bf16 ulps of max(1,
# |plain|) per element (2^-7): the lookup's fp32 sums in another order
# round to the same bf16 value but at a rounding boundary; the fused
# convc1 adds a 36-term sum; the update carries a flip in one conv's
# output through the six convs after it (measured 5.5 ulps at most at
# the serving shapes), so it is also held to a share of elements equal.
BF16_ULP = 2.0 ** -7
LOOKUP_BF16_ULPS, EPI_ULPS, UPDATE_BF16_ULPS = 1.0, 2.0, 8.0
UPDATE_BF16_EQUAL = 0.8
BF16_ITERS = 2   # card-vs-CPU bf16 forwards: iterations
# px, low-res / full-res, encoders pinned: on the CPU, the same forward
# with the loop's bf16 convs summed in another order moved the flagship's
# O(45) px disparities by 0.13-0.38 / 0.17-0.64 px after 2 iterations,
# against a bf16-vs-fp32 gap of 2.2-2.4 / 3.3-3.6 px.
BF16_FORWARD_TOL = (1.0, 1.5)
# Rows 3, 4 (general taps) and 8 against their plain versions: the lookup
# in fp32 within 1e-5 of max(1, |plain|) (dots of length 256 summed in
# another order), with a bf16 output within one bf16 ulp; the backward
# within BACKWARD_TOL of the largest gradient; instance norm within 1e-5
# of max(1, |plain|) in fp32 (plane sums of up to 138,240 values in
# another order) and one bf16 ulp in bf16.
TAPS_TOL, INORM_TOL = 1e-5, 1e-5
# The evaluation path: a synthetic KITTI tree at KITTI's resolution, the
# flagship model at 32 iterations; a tiled demo pair in 2x3 tiles.
KITTI_HW, KITTI_PAIRS = (375, 1242), 10
TILE = ((256, 640), 32, 128)  # tile shape, overlap, max disparity
# Source and replaced TPU kernel of each volume kernel row.
VOLUME_SITES = {
    "vol_lookup": ("corr_vol", "raftstereo_tpu/ops/pallas_corr.py:262"),
    "vol_lookup_bwd": ("corr_vol_bwd",
                       "raftstereo_tpu/ops/pallas_corr.py:288"),
    "int8_volume": ("int8_volume", "raftstereo_tpu/ops/quant.py:241")}
# Row names of the kernels whose counters carry another name.
COUNTER = {"alt_corr_bwd": "alt_corr_backward",
           "vol_lookup_bwd": "vol_lookup_backward",
           "int8_volume": "int8_corr_volume",
           "alt_corr_taps_bwd": "alt_corr_taps_backward",
           "instance_norm": "in_stats"}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, reps: int, rounds: int = 5) -> float:
    """Device time of one ``fn()`` call in ms: CUDA events around ``reps``
    back-to-back calls, divided by ``reps``; the median of ``rounds`` such
    rounds, after two warm-up calls.  A sleep kernel holds the stream
    while the host enqueues the calls, so the card runs them back to back
    even where one call's host work (argument checks, the ctypes call)
    outlasts its kernel; a round whose enqueue outlasted the sleep is
    repeated with a longer one (up to ~0.5 s, for functions that
    synchronise or fill the launch queue)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times, cycles = [], SLEEP_CYCLES
    while len(times) < rounds:
        z, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        z.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        if enqueue_ms < z.elapsed_time(a) or cycles >= 32 * SLEEP_CYCLES:
            times.append(a.elapsed_time(b) / reps)
        else:
            cycles *= 2
    return statistics.median(times)


def bound(nbytes: float, flops: float, int8_ops: float = 0.0,
          bf16_flops: float = 0.0, tf32_flops: float = 0.0):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_FP32_FLOP_PER_S + bf16_flops / PEAK_BF16_FLOP_PER_S
             + tf32_flops / PEAK_TF32_FLOP_PER_S
             + int8_ops / PEAK_INT8_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def post_predict(port: int, left: np.ndarray, right: np.ndarray) -> dict:
    def arr(a):
        return {"shape": list(a.shape), "dtype": "float32",
                "data_b64": base64.b64encode(a.tobytes()).decode("ascii")}

    body = json.dumps({"left": arr(left), "right": arr(right),
                       "iters": ITERS}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        check(r.status == 200, f"/predict answered {r.status}")
        return json.loads(r.read())


def lookup_row(state, x, r, path, torch):
    """The lookup kernel against its plain version on one path's inputs:
    error, times and bound."""
    from raftstereo_tpu_torch.ops import cuda_alt

    def kern():
        return cuda_alt.alt_corr(state.fmap1, state.f2cat, state.widths, x, r)

    def plain():
        return cuda_alt.alt_corr_plain(state.fmap1, state.f2cat,
                                       state.widths, x, r)

    err = float((kern() - plain()).abs().max())
    torch.cuda.synchronize()
    print(f"alt_corr ({path}, {tuple(x.shape)}) max_abs_err {err:.3e} "
          f"(tol {LOOKUP_TOL})")
    check(err <= LOOKUP_TOL, f"alt_corr disagrees with its plain version "
                             f"by {err} on the {path} path's shapes")
    ms, plain_ms = time_ms(kern, 50), time_ms(plain, 10)
    print(f"alt_corr ({path}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"[{CARD}]")
    k = 2 * r + 1
    valid = 0  # (pixel, level, column) pairs inside the level
    for lvl, w2 in enumerate(state.widths):
        b0 = torch.floor(x / 2 ** lvl)
        for d in range(k + 1):
            j = b0 + (d - r)
            valid += int(((j >= 0) & (j <= w2 - 1)).sum())
    npix, c = x.numel(), state.fmap1.shape[-1]
    nbytes = 4 * (state.fmap1.numel() + state.f2cat.numel() + x.numel()
                  + npix * len(state.widths) * k)
    flops = 2 * c * valid + 3 * npix * len(state.widths) * k
    return dict(name="alt_corr", path=path, route="cuda",
                source="raftstereo_tpu_torch/csrc/alt_corr.cu",
                replaces="raftstereo_tpu/ops/pallas_alt.py:158",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))),
                library_ms=None)


def update_row(model, lo_hw, disp, randn, path, torch):
    """The fused update kernel against its plain version at one path's
    1/4-resolution grid (inputs from ``randn``, the disparity ``disp``):
    error, times and bound.  h' and delta are each held to ``UPDATE_TOL``
    x max(1, |that output|): a single TF32 pass would miss it on h'
    (about 5e-4 at |h'| <= 1).  The bound is the tensor cores' for the
    kernel's 3xTF32 products (``bound_cuda_core_ms`` beside it)."""
    from raftstereo_tpu_torch.ops import cuda_gru

    cfg = model.config
    h, w = lo_hw
    hd = cfg.hidden_dims[0]
    n = cfg.n_gru_layers
    e = cfg.hidden_dims[1] if n > 1 else 0
    wpack = cuda_gru.pack_update_params(model.update_block, e)
    args = (torch.tanh(randn(1, h, w, hd)),
            torch.tanh(randn(1, h, w, e)) if e else None,
            randn(1, h, w, cfg.cor_planes), disp[..., None].contiguous(),
            randn(1, h, w, hd), randn(1, h, w, hd), randn(1, h, w, hd))
    hk, dk = cuda_gru.gru_update(*args, wpack)
    hp, dp = cuda_gru.gru_update_plain(*args, wpack)
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in (("h'", hk, hp), ("delta", dk, dp)):
        errs[name] = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        print(f"gru_update ({path}, {h}x{w}) {name} max_abs_err "
              f"{errs[name]:.3e} (tol {UPDATE_TOL} x {scale:.3g})")
        check(errs[name] <= UPDATE_TOL * scale,
              f"gru_update's {name} disagrees with its plain version by "
              f"{errs[name]} on the {path} path's shapes")
    err = max(errs.values())
    ms = time_ms(lambda: cuda_gru.gru_update(*args, wpack), 20)
    plain_ms = time_ms(lambda: cuda_gru.gru_update_plain(*args, wpack), 10)
    macs = update_macs(cfg.cor_planes, hd, e)
    flops = h * w * (2 * macs + 12 * hd)
    nbytes = 4 * (sum(a.numel() for a in args if a is not None)
                  + sum(wpack[k].numel() for k in cuda_gru.PLAIN_KEYS
                        if k in wpack)
                  + hk.numel() + dk.numel())
    # the kernel's products: three TF32 passes on the tensor cores; the
    # gate arithmetic on the CUDA cores
    tc_ms, bound_by = bound(nbytes, h * w * 12 * hd,
                            tf32_flops=3 * h * w * 2 * macs)
    cuda_core_ms = bound(nbytes, flops)[0]
    print(f"gru_update ({path}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"ms/plain {ms / plain_ms:.3f}; bound_ms {tc_ms:.4f} (3xTF32 "
          f"tensor cores), bound_cuda_core_ms {cuda_core_ms:.4f}, "
          f"ms/bound {ms / tc_ms:.2f} [{CARD}]")
    return dict(name="gru_update", path=path, route="cuda",
                source="raftstereo_tpu_torch/csrc/gru_update.cu",
                replaces="raftstereo_tpu/ops/pallas_gru.py:261",
                max_abs_err=err, max_abs_err_h=errs["h'"],
                max_abs_err_delta=errs["delta"], ms=ms, plain_ms=plain_ms,
                bound_ms=tc_ms, bound_by=bound_by, library_ms=None,
                bound_tc_ms=tc_ms, bound_cuda_core_ms=cuda_core_ms,
                ms_over_plain=ms / plain_ms, ms_over_bound_tc=ms / tc_ms)


def update_macs(cor_planes: int, hd: int, e: int) -> int:
    """Multiply-adds per pixel of one fused update."""
    return (cor_planes * 64 + 9 * 64 * 64 + 49 * 64 + 9 * 64 * 64
            + 9 * 128 * 126 + 9 * (hd + 127 + e) * 3 * hd
            + 9 * hd * 256 + 9 * 256 * 2)


_PTXAS_ARG = re.compile(r"13__nv_bfloat16|S1_|L[ib](\d+)E|f")


def _ptxas_label(mangled: str) -> str:
    """``gru_mma_conv_kernel<bf16,4,8>`` (or a plain kernel's name) from a
    mangled kernel name."""
    name = re.search(r"(gru_mma_conv_kernel|gru_simt_conv_kernel|"
                     r"conv3x3_few_out_kernel|pad_rows_kernel|"
                     r"enc_conv_tc_kernel)I(.*?)EEv", mangled)
    if not name:  # _ZN <namespace> <name> E...: lengths, then characters
        ns = re.match(r"_ZN(\d+)", mangled)
        at = ns.end() + int(ns.group(1)) if ns else 0
        n = re.match(r"\d+", mangled[at:]) if ns else None
        return (mangled[at + n.end():at + n.end() + int(n.group())] if n
                else mangled)
    args = [t.group(1) or ("fp32" if t.group(0) == "f" else "bf16")
            for t in _PTXAS_ARG.finditer(name.group(2))]
    return f"{name.group(1)}<{','.join(args)}>"


def build_report(name, lib) -> None:
    """A tensor-core library's kernels as ptxas reported them (registers,
    static shared memory, spills; row 2's mma kernel's dynamic shared
    memory is its TMA ring of 128-byte rows, BM = 32*MT pixel rows and BN
    = 16*NT weight rows per plane, 4 stages where one is at most 28 KB,
    else 3, and a barrier per stage; rows 9, 15 and 16's
    ``enc_conv_tc_kernel<stride,mode,projection,MT,NT>``'s is set at
    launch), and the tensor-core instructions in the library, which must
    not be 0."""
    entry = spill = None
    for line in lib.with_suffix(".log").read_text().splitlines():
        props = re.search(r"Function properties for (\S+)", line)
        used = re.search(r"Used (\d+) registers", line)
        if props:
            entry = _ptxas_label(props.group(1))
        elif entry and "spill" in line:
            spill = line.strip()
        elif entry and used:
            smem = re.search(r"(\d+) bytes smem", line)
            ring = ""
            k = re.match(r"gru_mma_conv_kernel<(\w+),(\d),(\d)>", entry)
            if k:
                planes = 2 if k.group(1) == "fp32" else 1
                rows = 32 * int(k.group(2)) + planes * 16 * int(k.group(3))
                stage = 128 * rows
                ring = (f", {(4 if stage <= 28 * 1024 else 3) * (stage + 8)} "
                        f"bytes dynamic smem")
            print(f"  {name} ptxas {entry}: {used.group(1)} registers, "
                  f"{smem.group(1) if smem else 0} bytes static smem{ring}; "
                  f"{spill}")
            entry = None
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print(f"  {name} SASS: cuobjdump missing")
        return
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True)
    if out.returncode != 0:
        print(f"  {name} SASS: cuobjdump exited {out.returncode}: "
              f"{out.stderr.strip()[:300]}")
        return
    hgmma = len(re.findall(r"\bHGMMA\b", out.stdout))
    hmma = len(re.findall(r"\bHMMA\b", out.stdout))
    print(f"  {name} SASS: {hmma} HMMA, {hgmma} HGMMA instructions "
          f"(cuobjdump -sass {lib.name})")
    check(hmma + hgmma > 0, f"{name}: no tensor-core instruction in the "
                            f"built library")


def kernel_phase(model, lo_hw, torch):
    """Each kernel against its plain version at each main path's shapes;
    one row per kernel and path."""
    from raftstereo_tpu_torch.ops import cuda_alt
    from raftstereo_tpu_torch.ops.corr import build_corr_state

    cfg = model.config
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    h, w = lo_hw
    c = model.feature_dim

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    rows = []
    # -- lookup, at the serving path's shapes
    state = build_corr_state(randn(1, h, w, c), randn(1, h, w, c),
                             cfg.corr_levels)
    disp = -60.0 * torch.rand((1, h, w), generator=g).to(dev)
    x = (torch.arange(w, device=dev, dtype=torch.float32) + disp).contiguous()
    r = cfg.corr_radius
    rows.append(lookup_row(state, x, r, "serve", torch))
    # -- the lookup on a smooth field (real disparities are smooth: a
    # low-frequency sine of x and y in [-60, 0]), and on jumps wider than
    # the kernel's staging buffer (its wide-span path), held only
    rows.append(lookup_row(state, smooth_field(1, h, w, torch), r,
                           "serve_smooth", torch))
    lookup_hold(state, jump_field(1, h, w, torch), r, "wide-span", torch)

    # -- update
    rows.append(update_row(model, lo_hw, disp, randn, "serve", torch))

    # -- lookup and its backward, at the training path's shapes
    bh, (th, tw) = TRAIN_BATCH, TRAIN_HW
    h, w = th // cfg.factor, tw // cfg.factor
    state = build_corr_state(randn(bh, h, w, c), randn(bh, h, w, c),
                             cfg.corr_levels)
    x = (torch.arange(w, device=dev, dtype=torch.float32)
         - 60.0 * torch.rand((bh, h, w), generator=g).to(dev)).contiguous()
    rows.append(lookup_row(state, x, r, "train", torch))
    k = 2 * r + 1
    lk = cfg.cor_planes
    gout = randn(bh, h, w, lk)

    def bwd():
        return cuda_alt.alt_corr_backward(state.fmap1, state.f2cat,
                                          state.widths, x, gout, r)

    def bwd_plain():
        return cuda_alt.alt_corr_backward_plain(state.fmap1, state.f2cat,
                                                state.widths, x, gout, r)

    k1, k2, want = bwd(), bwd(), bwd_plain()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
          "alt_corr_bwd: two calls on the same inputs differ")
    err = max(float((a - p).abs().max()) for a, p in zip(k1, want))
    scale = max(1.0, *(float(p.abs().max()) for p in want))
    print(f"alt_corr_bwd max_abs_err {err:.3e} (tol {BACKWARD_TOL} x "
          f"{scale:.3g}); bitwise repeatable")
    check(err <= BACKWARD_TOL * scale,
          f"alt_corr_bwd disagrees with its plain version by {err}")
    ms, plain_ms = time_ms(bwd, 20), time_ms(bwd_plain, 5)
    print(f"alt_corr_bwd ms {ms:.4f} plain_ms {plain_ms:.4f}")
    valid = 0  # (pixel, level, column) pairs inside the level
    for lvl, w2 in enumerate(state.widths):
        b0 = torch.floor(x / 2 ** lvl) - r
        for d in range(k + 1):
            j = b0 + d
            valid += int(((j >= 0) & (j <= w2 - 1)).sum())
    nbytes = 4 * (2 * state.fmap1.numel() + 2 * state.f2cat.numel()
                  + x.numel() + gout.numel())
    flops = 4 * c * valid + 4 * (k + 1) * x.numel() * len(state.widths)
    rows.append(dict(name="alt_corr_bwd", path="train", route="cuda",
                     source="raftstereo_tpu_torch/csrc/alt_corr_bwd.cu",
                     replaces="raftstereo_tpu/ops/pallas_alt.py:195",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     **dict(zip(("bound_ms", "bound_by"),
                                bound(nbytes, flops))),
                     library_ms=None))

    # -- infinite cotangents: the dense hat's +-inf on the columns their
    # taps weight, NaN on the level's others and on the pixel's df1
    xi, gi = x.clone(), gout.clone()
    xi[0, 5, 40], xi[1, 7, 90] = 80.5, 33.0   # level 1: x_l 40.25, 16.5
    gi[0, 5, 40, k] = float("inf")            # level 1, tap 0
    gi[1, 7, 90, k + r] = -float("inf")       # level 1, the middle tap
    got = cuda_alt.alt_corr_backward(state.fmap1, state.f2cat, state.widths,
                                     xi, gi, r)
    want = cuda_alt.alt_corr_backward_plain(state.fmap1, state.f2cat,
                                            state.widths, xi, gi, r)
    torch.cuda.synchronize()
    for name, a, w in zip(("df1", "df2"), got, want):
        inf, ok = w.isinf(), torch.isfinite(w)
        same = (torch.equal(a.isnan(), w.isnan())
                and torch.equal(a.isinf(), inf)
                and torch.equal(a[inf], w[inf]))
        err = float((a[ok] - w[ok]).abs().max())
        scale = max(1.0, float(w[ok].abs().max()))
        print(f"alt_corr_bwd (infinite cotangents) {name}: NaN and +-inf "
              f"where plain has them: {same} ({int(w.isnan().sum())} NaN, "
              f"{int(inf.sum())} inf); max_abs_err {err:.3e} elsewhere")
        check(same and err <= BACKWARD_TOL * scale,
              f"alt_corr_bwd's non-finite {name} differs from plain's")
    check(bool(got[1].isinf().any()), "alt_corr_bwd: no +-inf column")
    return rows


def smooth_field(b, h, w, torch):
    """x (b, h, w) on the card: column plus a disparity that is a
    low-frequency sine of x and y in [-60, 0]."""
    yy = torch.arange(b * h, dtype=torch.float32).reshape(b, h, 1)
    xx = torch.arange(w, dtype=torch.float32)
    disp = -30.0 + 30.0 * torch.sin(2 * np.pi * (xx / 97.0 + yy / 13.0))
    return (xx + disp).cuda().contiguous()


def jump_field(b, h, w, torch):
    """x (b, h, w) on the card: 8-pixel stripes near column 0 and near
    the row's end, so every tile's level-0 span exceeds the lookup
    kernel's staging buffer (its wide-span path)."""
    g = torch.Generator().manual_seed(9)
    xx = torch.arange(w, dtype=torch.float32)
    base = torch.where((xx // 8) % 2 == 1, float(w - 12), 0.0)
    return (base + 10.0 * torch.rand((b, h, w), generator=g)).cuda()


def lookup_hold(state, x, r, label, torch, dtype=None):
    """The lookup kernel against its plain version on x, timed, with no
    row: within LOOKUP_TOL (fp32) or LOOKUP_BF16_ULPS (bf16 out)."""
    from raftstereo_tpu_torch.ops import cuda_alt

    dtype = dtype or torch.float32

    def kern():
        return cuda_alt.alt_corr(state.fmap1, state.f2cat, state.widths, x,
                                 r, dtype)

    got = kern()
    want = cuda_alt.alt_corr_plain(state.fmap1, state.f2cat, state.widths,
                                   x, r, dtype)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        err, tol = ulps(got, want), LOOKUP_BF16_ULPS
    else:
        err, tol = float((got - want).abs().max()), LOOKUP_TOL
    ms = time_ms(kern, 50)
    print(f"alt_corr ({label}, {dims(x)}, {dtype}) err {err:.3e} (tol {tol})"
          f" ms {ms:.4f} [{CARD}]")
    check(err <= tol, f"alt_corr disagrees with its plain version by {err} "
                      f"on the {label} field")


def _leaves(out):
    if out is None:
        return []
    if hasattr(out, "shape"):
        return [out]
    return [t for o in out for t in _leaves(o)]


def dims(t) -> str:
    return "x".join(str(d) for d in t.shape)


def hold(label, kern, plain, n, tol, torch):
    """A kernel against its plain version on the same inputs: two kernel
    calls bitwise equal, and every output within tol x max(1, |plain|);
    (B, C) output sums are compared per pixel (divided by ``n``).
    Returns the largest absolute error of the first output."""
    k1, k2, want = kern(), kern(), plain()
    torch.cuda.synchronize()
    k1, k2, want = _leaves(k1), _leaves(k2), _leaves(want)
    check(len(k1) == len(want), f"{label}: {len(k1)} outputs vs "
                                f"{len(want)}")
    check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
          f"{label}: two calls on the same inputs differ")
    rel = 0.0
    for a, w in zip(k1, want):
        if a.dim() == 2:
            a, w = a / n, w / n
        err = float((a - w).abs().max())
        rel = max(rel, err / max(1.0, float(w.abs().max())))
    err0 = float((k1[0] - want[0]).abs().max())
    print(f"{label} max_abs_err {err0:.3e}, max rel {rel:.3e} (tol {tol}); "
          f"bitwise repeatable")
    check(rel <= tol, f"{label} disagrees with its plain version ({rel})")
    return err0


def conv_products(wt, out_numel, proj_flops=0):
    """FLOPs of an encoder conv's products (2 per MAC), its projection's
    too."""
    return 2 * out_numel * wt.shape[1] * wt.shape[2] * wt.shape[3] + proj_flops


def conv_cost(x, wt, out_numel, n_in=1, proj_flops=0):
    """FLOPs of an encoder conv: the products, the bias and the output
    sums, the input prep."""
    return (conv_products(wt, out_numel, proj_flops) + 4 * out_numel
            + 3 * n_in * x.numel())


# The source of each encoder row under csrc/ (enc_conv where not listed).
ENCODER_SOURCES = {"stage_conv": "enc_conv_tc", "l2_entry": "enc_conv_tc",
                   "l2_conv": "enc_conv_tc",
                   "stage_finish": "enc_finish", "l2_finish": "enc_finish",
                   "plane_stats": "enc_stats", "dual_sums": "enc_stats"}


def enc_row(rows, path, name, replaces, path_shape, kern, plain, n, tol,
            nbytes, flops, torch, lib=None, reps=5, products=0):
    """An encoder kernel held against its plain version and timed beside
    it (and ``lib``, one library computation of the same function, where
    there is one); appends its row for ``path``.  For the tensor-core
    rows, ``products`` of the ``flops`` run as three TF32 passes on the
    tensor cores (``bound_ms``; the rest on the CUDA cores), and
    ``bound_cuda_core_ms`` is the bound with all of them on the CUDA
    cores."""
    err = hold(f"{name} {path_shape}", kern, plain, n, tol, torch)
    ms, plain_ms = time_ms(kern, reps), time_ms(plain, reps)
    lib_ms = time_ms(lib, reps) if lib is not None else None
    bound_ms, bound_by = bound(nbytes, flops - products,
                               tf32_flops=3 * products)
    extra = {}
    if products:
        extra = dict(bound_tc_ms=bound_ms,
                     bound_cuda_core_ms=bound(nbytes, flops)[0])
    print(f"{name} {path_shape} ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {lib_ms} bound_ms {bound_ms:.4f} ({bound_by}"
          f"{', 3xTF32 tensor cores' if products else ''}); "
          + "".join(f"{k} {v:.4f} " for k, v in extra.items())
          + f"[{CARD}]")
    src = ENCODER_SOURCES.get(name, "enc_conv")
    rows.append(dict(name=name, path=path, shape=path_shape, route="cuda",
                     source=f"raftstereo_tpu_torch/csrc/{src}.cu",
                     replaces=replaces, max_abs_err=err, ms=ms,
                     plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=lib_ms, **extra))


def encoder_kernel_phase(model, bucket, torch):
    """The fused encoder kernels against their plain versions at the fused
    serving path's shapes (fnet: 2 images, instance norm with sums; cnet:
    1 image, batch norm without), plus the stride-2 conv1 at the
    ``n_downsample=3`` shape and the stats kernel at a batch-3 fnet; one
    timed row per kernel."""
    import torch.nn.functional as F

    from raftstereo_tpu_torch.ops import cuda_encoder as ce

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    def aff(b, c):  # shifts > 0: padding before the prep would show
        return ((0.5 + torch.rand((b, c), generator=g)).to(dev),
                (0.5 * torch.rand((b, c), generator=g)).to(dev))

    def wb(m):
        return m.weight.detach(), m.bias.detach()

    enc = model.fnet
    l0, l1 = enc.layer1
    m0, _ = enc.layer2
    h, w = bucket
    h2, w2 = h // 2, w // 2
    rows = []

    def row(*args, **kw):
        enc_row(rows, "serve_fused", *args, torch=torch, **kw)

    # -- fnet, 2 images: conv1 (row 13), layer1 (row 9), finish (row 11)
    img = torch.tanh(randn(2, 3, h, w))
    w1, b1 = wb(enc.conv1)
    n = float(h * w)
    out = 2 * 64 * h * w
    row("stem_conv7", "raftstereo_tpu/ops/pallas_encoder.py:648",
        dims(img), lambda: ce.stem_conv7(img, w1, b1),
        lambda: ce.conv_plain(img, w1, b1, 1), n, ENC_TOL,
        4 * (img.numel() + w1.numel() + 64 + out + 2 * 2 * 64),
        conv_cost(img, w1, out, n_in=0),
        lib=lambda: F.conv2d(img, w1, b1, 1, 3), reps=10)
    x = randn(2, 64, h, w)
    r = randn(2, 64, h, w)
    a, ra = aff(2, 64), aff(2, 64)
    wc, bc = wb(l0.conv1)
    hold(f"stage_conv res form {dims(x)}",
         lambda: ce.stage_conv(x, a, wc, bc, res=r, res_aff=ra),
         lambda: ce.conv_plain(x, wc, bc, 1, a, r, ra), n, ENC_TOL, torch)
    row("stage_conv", "raftstereo_tpu/ops/pallas_encoder.py:338, :348",
        dims(x), lambda: ce.stage_conv(x, a, wc, bc),
        lambda: ce.conv_plain(x, wc, bc, 1, a), n, ENC_TOL,
        4 * (2 * x.numel() + wc.numel() + 64 + 2 * 2 * 64 + 2 * 2 * 64),
        conv_cost(x, wc, x.numel(), n_in=1),
        lib=lambda: F.conv2d(x, wc, bc, 1, 1),
        products=conv_products(wc, x.numel()))
    c = randn(2, 64, h, w)
    a2, a3 = aff(2, 64), aff(2, 64)
    row("stage_finish", "raftstereo_tpu/ops/pallas_encoder.py:364",
        dims(x), lambda: ce.stage_finish(x, a, r, a2, c, a3),
        lambda: ce.finish_plain(x, a, r, a2, c, a3), n, FINISH_TOL,
        4 * (4 * x.numel() + 6 * 2 * 64), 12 * x.numel(), reps=20)

    # -- fnet layer2: entry (row 15), convs (row 16), finish (row 17)
    t = torch.relu(x)
    we, be = wb(m0.conv1)
    wp, bp = wb(m0.downsample[0])
    n2 = float(h2 * w2)
    out2 = 2 * 96 * h2 * w2
    row("l2_entry", "raftstereo_tpu/ops/pallas_layer2.py:118",
        dims(t), lambda: ce.l2_entry(t, we, be, wp, bp),
        lambda: ce.entry_plain(t, we, be, wp, bp), n2, ENC_TOL,
        4 * (t.numel() + we.numel() + wp.numel() + 2 * 96 + 2 * out2
             + 2 * 2 * 2 * 96),
        conv_cost(t, we, out2, n_in=0, proj_flops=2 * out2 * 64) + 4 * out2,
        lib=lambda: F.conv2d(t, we, be, 2, 1),
        products=conv_products(we, out2, proj_flops=2 * out2 * 64))
    y = randn(2, 96, h2, w2)
    p = randn(2, 96, h2, w2)
    b_, pb = aff(2, 96), aff(2, 96)
    wl, bl = wb(m0.conv2)
    hold(f"l2_conv res form {dims(y)}",
         lambda: ce.l2_conv(y, b_, wl, bl, res=p, res_aff=pb),
         lambda: ce.conv_plain(y, wl, bl, 1, b_, p, pb, res_relu=False),
         n2, ENC_TOL, torch)
    row("l2_conv", "raftstereo_tpu/ops/pallas_layer2.py:201, :212",
        dims(y), lambda: ce.l2_conv(y, b_, wl, bl),
        lambda: ce.conv_plain(y, wl, bl, 1, b_), n2, ENC_TOL,
        4 * (2 * y.numel() + wl.numel() + 96 + 4 * 2 * 96),
        conv_cost(y, wl, y.numel(), n_in=1),
        lib=lambda: F.conv2d(y, wl, bl, 1, 1),
        products=conv_products(wl, y.numel()))
    q, a4 = randn(2, 96, h2, w2), aff(2, 96)
    row("l2_finish", "raftstereo_tpu/ops/pallas_layer2.py:228",
        dims(y), lambda: ce.l2_finish(p, pb, y, b_, q, a4),
        lambda: ce.finish_plain(p, pb, y, b_, q, a4, a_relu=False), n2,
        FINISH_TOL, 4 * (4 * y.numel() + 6 * 2 * 96), 12 * y.numel(),
        reps=20)

    # -- cnet, 1 image, batch norm: the same kernels without sums
    img1, x1, t1 = img[:1].contiguous(), x[:1].contiguous(), t[:1].contiguous()
    ab = aff(1, 64)
    for label, kern, plain in (
            (f"stem_conv7 {dims(img1)} no sums",
             lambda: ce.stem_conv7(img1, w1, b1, want_stats=False),
             lambda: ce.conv_plain(img1, w1, b1, 1, want_stats=False)),
            (f"stage_conv {dims(x1)} no sums",
             lambda: ce.stage_conv(x1, ab, wc, bc, want_stats=False),
             lambda: ce.conv_plain(x1, wc, bc, 1, ab, want_stats=False)),
            (f"l2_entry {dims(t1)} no sums",
             lambda: ce.l2_entry(t1, we, be, wp, bp, want_stats=False),
             lambda: ce.entry_plain(t1, we, be, wp, bp, want_stats=False)),
            (f"l2_conv {dims(y[:1])} no sums",
             lambda: ce.l2_conv(y[:1].contiguous(), (b_[0][:1], b_[1][:1]),
                                wl, bl, want_stats=False),
             lambda: ce.conv_plain(y[:1], wl, bl, 1, (b_[0][:1], b_[1][:1]),
                                   want_stats=False)),
            (f"l2_conv res form {dims(y[:1])} no sums",
             lambda: ce.l2_conv(y[:1].contiguous(), (b_[0][:1], b_[1][:1]),
                                wl, bl, res=p[:1].contiguous(),
                                res_aff=(pb[0][:1], pb[1][:1]),
                                want_stats=False),
             lambda: ce.conv_plain(y[:1], wl, bl, 1, (b_[0][:1], b_[1][:1]),
                                   p[:1], (pb[0][:1], pb[1][:1]),
                                   res_relu=False, want_stats=False))):
        hold(label, kern, plain, 1.0, ENC_TOL, torch)

    # -- off the batch-1 path: the stride-2 conv1 (row 12) at the
    # n_downsample=3 shape, the stats kernel (row 10) at a batch-3 fnet
    outs2 = 2 * 64 * h2 * w2
    row("stem_conv7_s2", "raftstereo_tpu/ops/pallas_encoder.py:721",
        f"{dims(img)} (n_downsample=3)",
        lambda: ce.stem_conv7_s2(img, w1, b1),
        lambda: ce.conv_plain(img, w1, b1, 2), n2, ENC_TOL,
        4 * (img.numel() + w1.numel() + 64 + outs2 + 2 * 2 * 64),
        conv_cost(img, w1, outs2, n_in=0),
        lib=lambda: F.conv2d(img, w1, b1, 2, 3), reps=10)
    big = randn(6, 64, h, w)
    row("plane_stats", "raftstereo_tpu/ops/pallas_norm.py:47 (via "
        "pallas_encoder.py:476)", f"{dims(big)} (batch 3)",
        lambda: ce.plane_stats(big), lambda: ce.stats_plain(big), n,
        ENC_TOL, 4 * (big.numel() + 2 * 6 * 64), 3 * big.numel(),
        lib=lambda: torch.var_mean(big, dim=(2, 3), correction=0), reps=10)
    return rows


def train_fused_kernel_phase(model, torch):
    """The kernels that the fused training path launches, held against
    their plain versions and timed at its shapes: fnet's 12 images of
    320x720 (cnet's 6 images take the same kernels without sums), layer2
    at 160x360, the stats kernel on conv1's output, and the backward's
    dual sums (row 14) of two such tensors; one row per kernel."""
    import torch.nn.functional as F

    from raftstereo_tpu_torch.ops import cuda_encoder as ce

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    def aff(b, c):  # shifts > 0: padding before the prep would show
        return ((0.5 + torch.rand((b, c), generator=g)).to(dev),
                (0.5 * torch.rand((b, c), generator=g)).to(dev))

    def wb(m):
        return m.weight.detach(), m.bias.detach()

    rows = []

    def row(*args, **kw):
        enc_row(rows, "train_fused", *args, torch=torch, **kw)

    enc = model.fnet
    l0, _ = enc.layer1
    m0, _ = enc.layer2
    b, (h, w) = 2 * TRAIN_BATCH, TRAIN_HW
    h2, w2 = h // 2, w // 2
    n, n2 = float(h * w), float(h2 * w2)

    # -- the backward's dual sums (row 14), then the stage's kernels
    u, v = randn(b, 64, h, w), randn(b, 64, h, w)
    row("dual_sums", "raftstereo_tpu/ops/pallas_encoder.py:1148",
        dims(u), lambda: ce.dual_sums(u, v), lambda: ce.dual_sums_plain(u, v),
        n, DUAL_TOL, 4 * (u.numel() + v.numel() + 2 * b * 64),
        3 * u.numel(), reps=10,
        lib=lambda: (u.sum((2, 3)), torch.einsum("bchw,bchw->bc", u, v)))
    del u, v
    x = randn(b, 64, h, w)
    row("plane_stats", "raftstereo_tpu/ops/pallas_norm.py:47 (via "
        "pallas_encoder.py:476)", dims(x), lambda: ce.plane_stats(x),
        lambda: ce.stats_plain(x), n, ENC_TOL,
        4 * (x.numel() + 2 * b * 64), 3 * x.numel(), reps=10,
        lib=lambda: torch.var_mean(x, dim=(2, 3), correction=0))
    a = aff(b, 64)
    wc, bc = wb(l0.conv1)
    row("stage_conv", "raftstereo_tpu/ops/pallas_encoder.py:338, :348",
        dims(x), lambda: ce.stage_conv(x, a, wc, bc),
        lambda: ce.conv_plain(x, wc, bc, 1, a), n, ENC_TOL,
        4 * (2 * x.numel() + wc.numel() + 64 + 4 * b * 64),
        conv_cost(x, wc, x.numel(), n_in=1),
        lib=lambda: F.conv2d(x, wc, bc, 1, 1),
        products=conv_products(wc, x.numel()))
    r, c = randn(b, 64, h, w), randn(b, 64, h, w)
    a2, a3 = aff(b, 64), aff(b, 64)
    # row 9's residual form (fnet), and cnet's 6 images without sums
    hold(f"stage_conv res form {dims(x)}",
         lambda: ce.stage_conv(x, a, wc, bc, res=r, res_aff=a2),
         lambda: ce.conv_plain(x, wc, bc, 1, a, r, a2), n, ENC_TOL, torch)
    half = b // 2
    x1 = x[:half].contiguous()
    a1 = (a[0][:half].contiguous(), a[1][:half].contiguous())
    hold(f"stage_conv {dims(x1)} no sums",
         lambda: ce.stage_conv(x1, a1, wc, bc, want_stats=False),
         lambda: ce.conv_plain(x1, wc, bc, 1, a1, want_stats=False), 1.0,
         ENC_TOL, torch)
    del x1
    row("stage_finish", "raftstereo_tpu/ops/pallas_encoder.py:364",
        dims(x), lambda: ce.stage_finish(x, a, r, a2, c, a3),
        lambda: ce.finish_plain(x, a, r, a2, c, a3), n, FINISH_TOL,
        4 * (4 * x.numel() + 6 * b * 64), 12 * x.numel(), reps=10)
    del r, c
    t = torch.relu(x)
    del x
    we, be = wb(m0.conv1)
    wp, bp = wb(m0.downsample[0])
    out2 = b * 96 * h2 * w2
    row("l2_entry", "raftstereo_tpu/ops/pallas_layer2.py:118", dims(t),
        lambda: ce.l2_entry(t, we, be, wp, bp),
        lambda: ce.entry_plain(t, we, be, wp, bp), n2, ENC_TOL,
        4 * (t.numel() + we.numel() + wp.numel() + 2 * 96 + 2 * out2
             + 2 * 2 * b * 96),
        conv_cost(t, we, out2, n_in=0, proj_flops=2 * out2 * 64) + 4 * out2,
        lib=lambda: F.conv2d(t, we, be, 2, 1),
        products=conv_products(we, out2, proj_flops=2 * out2 * 64))
    t1 = t[:half].contiguous()
    hold(f"l2_entry {dims(t1)} no sums",
         lambda: ce.l2_entry(t1, we, be, wp, bp, want_stats=False),
         lambda: ce.entry_plain(t1, we, be, wp, bp, want_stats=False), 1.0,
         ENC_TOL, torch)
    del t, t1
    y, p, q = (randn(b, 96, h2, w2) for _ in range(3))
    b_, pb, a4 = aff(b, 96), aff(b, 96), aff(b, 96)
    wl, bl = wb(m0.conv2)
    row("l2_conv", "raftstereo_tpu/ops/pallas_layer2.py:201, :212",
        dims(y), lambda: ce.l2_conv(y, b_, wl, bl),
        lambda: ce.conv_plain(y, wl, bl, 1, b_), n2, ENC_TOL,
        4 * (2 * y.numel() + wl.numel() + 96 + 4 * b * 96),
        conv_cost(y, wl, y.numel(), n_in=1),
        lib=lambda: F.conv2d(y, wl, bl, 1, 1),
        products=conv_products(wl, y.numel()))
    # row 16's res_proj form (fnet), and cnet's 6 images without sums
    hold(f"l2_conv res form {dims(y)}",
         lambda: ce.l2_conv(y, b_, wl, bl, res=p, res_aff=pb),
         lambda: ce.conv_plain(y, wl, bl, 1, b_, p, pb, res_relu=False),
         n2, ENC_TOL, torch)
    y1 = y[:half].contiguous()
    b1 = (b_[0][:half].contiguous(), b_[1][:half].contiguous())
    hold(f"l2_conv {dims(y1)} no sums",
         lambda: ce.l2_conv(y1, b1, wl, bl, want_stats=False),
         lambda: ce.conv_plain(y1, wl, bl, 1, b1, want_stats=False), 1.0,
         ENC_TOL, torch)
    del y1
    row("l2_finish", "raftstereo_tpu/ops/pallas_layer2.py:228", dims(y),
        lambda: ce.l2_finish(p, pb, y, b_, q, a4),
        lambda: ce.finish_plain(p, pb, y, b_, q, a4, a_relu=False), n2,
        FINISH_TOL, 4 * (4 * y.numel() + 6 * b * 96), 12 * y.numel(),
        reps=10)
    return rows


def same_bits(a, b, torch) -> bool:
    """Equal NaN positions and equal values elsewhere."""
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)))


def volume_kernel_phase(cfg, lo_hw, torch):
    """The precomputed-volume kernels against their plain versions at the
    serving and training shapes, bitwise; one timed row per kernel and
    path."""
    from raftstereo_tpu_torch.ops import cuda_vol, quant
    from raftstereo_tpu_torch.ops.corr import build_corr_state

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(2)
    c, r = 256, cfg.corr_radius  # fnet's feature width
    k = 2 * r + 1

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    def coords(b, h, w):
        return (torch.arange(w, device=dev, dtype=torch.float32)
                - 60.0 * torch.rand((b, h, w), generator=g).to(dev)
                ).contiguous()

    def timed(name, path, kern, plain, nbytes, flops, lib=None,
              int8_ops=0.0, reps=20):
        ms, plain_ms = time_ms(kern, reps), time_ms(plain, 5)
        lib_ms = time_ms(lib, 5) if lib is not None else None
        print(f"{name} ({path}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"library_ms {lib_ms}")
        src, replaces = VOLUME_SITES[name]
        return dict(name=name, path=path, route="cuda",
                    source=f"raftstereo_tpu_torch/csrc/{src}.cu",
                    replaces=replaces, max_abs_err=0.0, ms=ms,
                    plain_ms=plain_ms,
                    **dict(zip(("bound_ms", "bound_by"),
                               bound(nbytes, flops, int8_ops))),
                    library_ms=lib_ms)

    def sampler(vcat, widths, x, grad=False):
        """One PyTorch call per level for the same lookup: the upstream
        RAFT-Stereo ``bilinear_sampler``, ``F.grid_sample`` of the level's
        1-D volume rows (B*H*W1, 1, 1, w) at the 2r+1 taps, align_corners,
        zero padding.  Returns per level (volume, grid), the volume a leaf
        that requires grad with ``grad``."""
        import torch.nn.functional as F

        out, off = [], 0
        for lvl, w in enumerate(widths):
            v = vcat[..., off:off + w].reshape(-1, 1, 1, w).clone()
            taps = (x.reshape(-1, 1) / 2 ** lvl
                    + torch.arange(-r, r + 1, device=dev))
            gx = 2.0 * taps / max(w - 1, 1) - 1.0
            grid = torch.stack([gx, torch.zeros_like(gx)], -1)[:, None]
            out.append((v.requires_grad_(grad), grid))
            off += w
        return out, [lambda v=v, gr=gr: F.grid_sample(v, gr,
                                                      align_corners=True)
                     for v, gr in out]

    def needed_columns(x, widths):
        """(pixel, level, column) entries inside the level that the taps
        weight: columns floor(x_l) - r .. floor(x_l) + r + 1."""
        n = 0
        for lvl, w in enumerate(widths):
            b0 = torch.floor(x / 2 ** lvl) - r
            for d in range(k + 1):
                j = b0 + d
                n += int(((j >= 0) & (j <= w - 1)).sum())
        return n

    rows = []
    for path, (b, h, w) in (("serve_pallas", (1,) + tuple(lo_hw)),
                            ("train_pallas", (TRAIN_BATCH,
                                              TRAIN_HW[0] // cfg.factor,
                                              TRAIN_HW[1] // cfg.factor))):
        st = build_corr_state(randn(b, h, w, c), randn(b, h, w, c),
                              cfg.corr_levels, "pallas")
        x = coords(b, h, w)

        def kern():
            return cuda_vol.vol_lookup(st.vcat, st.widths, x, r)

        def plain():
            return cuda_vol.vol_lookup_plain(st.vcat, st.widths, x, r)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        print(f"vol_lookup ({path}, vcat {dims(st.vcat)}): bitwise equal "
              f"to its plain version: {same_bits(got, want, torch)}")
        check(same_bits(got, want, torch),
              f"vol_lookup differs from its plain version ({path})")
        _, calls = sampler(st.vcat, st.widths, x)
        lib_out = torch.cat([f().reshape(got.shape[:3] + (k,))
                             for f in calls], -1)
        print(f"vol_lookup ({path}) library: {len(calls)} F.grid_sample "
              f"calls, one per level, max |diff| "
              f"{float((lib_out - got).abs().max()):.3e}")
        nout = got.numel()
        rows.append(timed(
            "vol_lookup", path, kern, plain,
            4 * (needed_columns(x, st.widths) + x.numel() + nout),
            8 * nout, lib=lambda: [f() for f in calls]))
        if path != "train_pallas":
            continue
        gout = randn(b, h, w, cfg.corr_levels * k)

        def bwd():
            return cuda_vol.vol_lookup_backward(x, gout, st.widths, r)

        def bwd_plain():
            return cuda_vol.vol_lookup_backward_plain(x, gout, st.widths, r)

        k1, k2, want = bwd(), bwd(), bwd_plain()
        torch.cuda.synchronize()
        ok = same_bits(k1, k2, torch) and same_bits(k1, want, torch)
        print(f"vol_lookup_bwd ({path}, dvol {dims(k1)}): two calls and the "
              f"plain version bitwise equal: {ok}")
        check(ok, "vol_lookup_bwd is not bitwise repeatable or differs from "
                  "its plain version")
        # the library: the autograd backward of the 4 F.grid_sample calls
        levels, calls = sampler(st.vcat, st.widths, x, grad=True)
        outs = [f() for f in calls]
        gouts = [gout[..., lvl * k:(lvl + 1) * k].reshape(o.shape)
                 for lvl, o in enumerate(outs)]

        def lib_bwd():
            return [torch.autograd.grad(o, v, go, retain_graph=True)
                    for o, (v, _), go in zip(outs, levels, gouts)]

        rows.append(timed("vol_lookup_bwd", path, bwd, bwd_plain,
                          4 * (k1.numel() + gout.numel() + x.numel()),
                          6 * k * k1.numel(), lib=lib_bwd, reps=10))
        del levels, calls, outs, gouts
        vol_bwd_nonfinite_hold(x, gout, st.widths, r, torch)

    # -- the int8 volume at the serving shape
    h, w = lo_hw
    q1, s1 = quant.quantize_rows(randn(1, h, w, c))
    q2, s2 = quant.quantize_rows(randn(1, h, w, c))

    def vol():
        return quant.int8_corr_volume(q1, s1, q2, s2)

    def vol_plain():
        return quant.int8_volume_plain(q1, s1, q2, s2)

    def int_mm():  # the int32 product alone, one cuBLASLt call per row
        return [torch._int_mm(q1[0, y], q2[0, y].t()) for y in range(h)]

    got, want = vol(), vol_plain()
    torch.cuda.synchronize()
    print(f"int8_volume (serve_quant, {dims(got)}): bitwise equal to its "
          f"plain version: {torch.equal(got, want)}")
    check(torch.equal(got, want), "int8_volume differs from its plain version")
    rows.append(timed("int8_volume", "serve_quant", vol, vol_plain,
                      q1.numel() + q2.numel()
                      + 4 * (s1.numel() + s2.numel() + got.numel()),
                      3 * got.numel(), lib=int_mm,
                      int8_ops=2 * got.numel() * c))
    return rows


def vol_bwd_nonfinite_hold(x, gout, widths, r, torch) -> None:
    """Row 6 on NaN coordinates, +-inf and NaN cotangents, integer and
    half-integer coordinates and coordinates far past both edges: NaN
    where plain is NaN and the same bits elsewhere (+0, -0 and +-inf
    included), two calls alike."""
    from raftstereo_tpu_torch.ops import cuda_vol

    k = 2 * r + 1
    x, g = x.clone(), gout.clone()
    x[0, 0, :10] = torch.tensor([float("nan"), -200.5, 480.25, 1e7, -1e7,
                                 1e30, -1e30, float("inf"), -float("inf"),
                                 2.0 ** 24 + 2])
    x[0, 1] = torch.arange(x.shape[2], device=x.device) * 0.5 - 8.0
    x[0, 2, 3], x[0, 2, 9] = r + 0.5, 0.25 - r
    g[0, 2, 3, 0] = float("inf")       # level 0's first tap: columns 0, 1
    g[0, 2, 9, k - 1] = -float("inf")  # its last tap: columns 0, 1
    g[1, 0, 5, k + 2] = float("nan")
    g[1, 1, :, 0] = -0.0
    g[1, 2, :, -1] = 1e-41             # subnormal
    k1, k2 = (cuda_vol.vol_lookup_backward(x, g, widths, r) for _ in "ab")
    want = cuda_vol.vol_lookup_backward_plain(x, g, widths, r)
    torch.cuda.synchronize()
    ok = ~want.isnan()
    same = all(torch.equal(a.isnan(), ~ok)
               and torch.equal(a[ok].view(torch.int32),
                               want[ok].view(torch.int32)) for a in (k1, k2))
    print(f"vol_lookup_bwd (non-finite and far inputs, dvol {dims(k1)}): "
          f"bitwise equal to plain and repeatable: {same} "
          f"({int((~ok).sum())} NaN, {int(want.isinf().sum())} inf)")
    check(same and bool(want.isinf().any()),
          "vol_lookup_bwd differs from its plain version on non-finite "
          "inputs")


def ulps(got, want) -> float:
    """Largest difference in bf16 ulps of max(1, |want|) (2^-7 each)."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max()
                 ) / BF16_ULP


def bf16_kernel_phase(model, lo_hw, torch):
    """The bf16 kernels against their plain versions at the bf16 serving
    shapes (144x240, C=256, bf16 feature maps, hidden 128): the lookup's
    bf16 form (path ``serve_bf16``), the lookup with convc1 fused in
    (``serve_bf16_xla``) and the update's bf16 form (``serve_bf16``);
    one timed row each."""
    from raftstereo_tpu_torch.ops import cuda_alt, cuda_gru
    from raftstereo_tpu_torch.ops.corr import build_corr_state

    cfg = model.config
    dev = torch.device("cuda")
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(4)
    h, w = lo_hw
    c, hd, r = model.feature_dim, cfg.hidden_dims[0], cfg.corr_radius
    k = 2 * r + 1

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    state = build_corr_state(randn(1, h, w, c), randn(1, h, w, c),
                             cfg.corr_levels, corr_dtype=bf)
    disp = -60.0 * torch.rand((1, h, w), generator=g).to(dev)
    x = (torch.arange(w, device=dev, dtype=torch.float32) + disp).contiguous()
    valid = 0  # (pixel, level, column) window dots inside the level
    for lvl, w2 in enumerate(state.widths):
        b0 = torch.floor(x / 2 ** lvl)
        for d in range(k + 1):
            j = b0 + (d - r)
            valid += int(((j >= 0) & (j <= w2 - 1)).sum())
    npix, lk = x.numel(), cfg.cor_planes
    fbytes = 2 * (state.fmap1.numel() + state.f2cat.numel()) + 4 * npix
    rows = []

    def row(name, path, src, replaces, kern, plain, tol, nbytes, flops,
            bf16_flops, reps, min_equal=0.0, **extra):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        outs = list(zip(_leaves(got), _leaves(want)))
        err = max(ulps(a, b) for a, b in outs)
        abs_err = max(float((a.float() - b.float()).abs().max())
                      for a, b in outs)
        equal = min(float((a == b).float().mean()) for a, b in outs)
        print(f"{name} ({path}) max {err:.3f} bf16 ulps, max_abs_err "
              f"{abs_err:.3e}, {equal:.5f} of elements equal (tol {tol} "
              f"ulps, {min_equal} equal)")
        check(all(a.dtype == bf for a, _ in outs), f"{name}: not bf16")
        check(err <= tol and equal >= min_equal,
              f"{name} ({path}) disagrees with its plain version by {err} "
              f"bf16 ulps, {equal} of elements equal")
        ms, plain_ms = time_ms(kern, reps), time_ms(plain, 5)
        bound_ms, bound_by = bound(nbytes, flops, bf16_flops=bf16_flops)
        print(f"{name} ({path}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {bound_ms:.4f} ({bound_by}) {extra}")
        rows.append(dict(name=name, path=path, route="cuda",
                         source=f"raftstereo_tpu_torch/csrc/{src}.cu",
                         replaces=replaces, max_abs_err=abs_err,
                         max_bf16_ulps=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None, **extra))

    lookup_hold(state, jump_field(1, h, w, torch), r, "wide-span", torch,
                bf)
    row("alt_corr", "serve_bf16", "alt_corr",
        "raftstereo_tpu/ops/pallas_alt.py:158",
        lambda: cuda_alt.alt_corr(state.fmap1, state.f2cat, state.widths, x,
                                  r, bf),
        lambda: cuda_alt.alt_corr_plain(state.fmap1, state.f2cat,
                                        state.widths, x, r, bf),
        LOOKUP_BF16_ULPS, fbytes + 2 * npix * lk, 3 * npix * lk,
        2 * c * valid, 50)
    c1 = model.update_block.encoder.convc1
    ew = c1.weight.detach()[:, :, 0, 0].t().to(bf).contiguous()
    eb = c1.bias.detach().to(bf).contiguous()
    row("alt_corr_epi", "serve_bf16_xla", "alt_corr_epi",
        "raftstereo_tpu/ops/pallas_alt.py:172",
        lambda: cuda_alt.alt_corr_epi(state.fmap1, state.f2cat, state.widths,
                                      x, r, ew, eb),
        lambda: cuda_alt.alt_corr_epi_plain(state.fmap1, state.f2cat,
                                            state.widths, x, r, ew, eb),
        EPI_ULPS, fbytes + 2 * (ew.numel() + eb.numel() + npix * 64),
        3 * npix * lk + 2 * npix * 64, 2 * c * valid + 2 * npix * lk * 64,
        50)

    n = cfg.n_gru_layers
    e = cfg.hidden_dims[1] if n > 1 else 0
    wpack = cuda_gru.pack_update_params(model.update_block, e, bf)
    args = (torch.tanh(randn(1, h, w, hd)).to(bf),
            torch.tanh(randn(1, h, w, e)).to(bf) if e else None,
            randn(1, h, w, lk).to(bf), disp[..., None].contiguous(),
            randn(1, h, w, hd).to(bf), randn(1, h, w, hd).to(bf),
            randn(1, h, w, hd).to(bf))
    macs = update_macs(lk, hd, e)
    nbytes = (2 * sum(a.numel() for a in args if a is not None)
              - 2 * npix + 4 * npix
              + 2 * sum(wpack[k].numel() for k in cuda_gru.PLAIN_KEYS
                        if k in wpack)
              + 2 * npix * (hd + 2))
    # the row's bound_ms: the products on the tensor cores, the gate
    # arithmetic on the CUDA cores
    tc_ms = bound(nbytes, npix * 12 * hd, bf16_flops=2 * macs * npix)[0]
    row("gru_update", "serve_bf16", "gru_update",
        "raftstereo_tpu/ops/pallas_gru.py:261",
        lambda: cuda_gru.gru_update(*args, wpack),
        lambda: cuda_gru.gru_update_plain(*args, wpack),
        UPDATE_BF16_ULPS, nbytes, npix * 12 * hd, 2 * macs * npix, 20,
        min_equal=UPDATE_BF16_EQUAL,
        bound_cuda_core_ms=bound(nbytes, npix * (2 * macs + 12 * hd))[0],
        bound_tc_ms=tc_ms)
    upd = rows[-1]
    upd.update(ms_over_plain=upd["ms"] / upd["plain_ms"],
               ms_over_bound_tc=upd["ms"] / tc_ms)
    print(f"gru_update (serve_bf16) ms/plain {upd['ms_over_plain']:.3f}; "
          f"bound_ms {tc_ms:.4f} (bf16 tensor cores), bound_cuda_core_ms "
          f"{upd['bound_cuda_core_ms']:.4f}, ms/bound "
          f"{upd['ms_over_bound_tc']:.2f} [{CARD}]")
    return rows


def bf16_forward_card_vs_cpu(model, rng, torch):
    """A bf16 model's card forward (kernels) against the CPU's (plain
    versions) on a 64x96 pair, with the card's encoder outputs pinned in
    the CPU forward: the encoders' bf16 convs round about one output in
    10^4 to the other side on the card, instance norm spreads such a flip
    over its channel, and the random-weight GRU grows that noise as fast
    as bf16's own rounding.  Pinned, what is compared is the rest of the
    forward: the context convs, the bf16 correlation state, every
    iteration's kernels and the upsampling.  The gap of the CPU's bf16
    forward to its fp32 one (unpinned) is printed beside the tolerance,
    which must lie below it."""
    from raftstereo_tpu_torch import RAFTStereo

    cfg = model.config
    cpu_model = copy.deepcopy(model).to("cpu")
    f32_model = RAFTStereo(dataclasses.replace(
        cfg, compute_dtype="float32", corr_dtype="float32"), device="cpu")
    f32_model.load_state_dict(cpu_model.state_dict())
    i1, i2 = (torch.from_numpy(rng.uniform(0, 255, (1, 64, 96, 3))
                               .astype(np.float32)) for _ in range(2))
    seen = {}
    cnet, fnet = model.cnet.forward, model.fnet.forward
    model.cnet.forward = lambda x: seen.setdefault("cnet", cnet(x))
    model.fnet.forward = lambda x: seen.setdefault("fnet", fnet(x))
    try:
        lo_g, up_g = model(i1.cuda(), i2.cuda(), iters=BF16_ITERS)
    finally:
        del model.cnet.forward, model.fnet.forward
    cpu_model.cnet.forward = lambda x: [[t.cpu() for t in lvl]
                                        for lvl in seen["cnet"]]
    cpu_model.fnet.forward = lambda x: seen["fnet"].cpu()
    lo_c, up_c = cpu_model(i1, i2, iters=BF16_ITERS)
    lo_f, up_f = f32_model(i1, i2, iters=BF16_ITERS)
    tag = f"bf16 {cfg.corr_dtype} corr, {cfg.gru_backend} GRU "
    for name, a, b, f, tol in (
            ("low-res", lo_g.cpu(), lo_c, lo_f, BF16_FORWARD_TOL[0]),
            ("full-res", up_g.cpu(), up_c, up_f, BF16_FORWARD_TOL[1])):
        err = float((a - b).abs().max())
        gap = float((b - f).abs().max())
        print(f"{tag}forward {name} card vs cpu (encoders pinned) max_abs_err "
              f"{err:.3e} (tol {tol}); cpu bf16 vs fp32 {gap:.3e}")
        check(bool(torch.isfinite(a).all()) and err <= tol < gap,
              f"card {tag}forward differs from the CPU forward ({name}: "
              f"{err}, tol {tol}, bf16-vs-fp32 gap {gap})")


def serving_wrappers():
    """Every counted kernel wrapper a served request may launch."""
    from raftstereo_tpu_torch.ops import (cuda_alt, cuda_encoder, cuda_gru,
                                         cuda_vol, quant)

    return ((cuda_alt.alt_corr, cuda_alt.alt_corr_epi, cuda_gru.gru_update,
             cuda_vol.vol_lookup, quant.int8_corr_volume)
            + cuda_encoder.WRAPPERS)


def serve_phase(model, scfg, pairs, torch):
    """Three requests through ``/predict``: replies, and launches per
    counted wrapper over exactly those requests."""
    from raftstereo_tpu_torch.serve.server import build_server, decode_array

    t0 = time.perf_counter()
    server = build_server(model, scfg, device="cuda")
    print(f"server warm in {time.perf_counter() - t0:.1f}s")
    server.start()
    counted = serving_wrappers()
    try:
        for fn in counted:
            fn.launches = 0
        replies = []
        for left, right in pairs:
            t0 = time.perf_counter()
            replies.append(post_predict(server.port, left, right))
            print(f"/predict {time.perf_counter() - t0:.3f}s "
                  f"meta {replies[-1]['meta']}")
        launches = {fn.__name__: fn.launches for fn in counted}
    finally:
        server.shutdown()
        server.server_close()
    print(f"launches {launches}")
    for (left, right), rep in zip(pairs, replies):
        disp = decode_array(rep["disparity"])
        check(disp.shape == IMAGE_HW, f"reply shape {disp.shape}")
        check(bool(np.isfinite(disp).all()), "non-finite disparity")
        (direct,) = server.engine.infer_batch([(left, right)], ITERS)
        check(np.array_equal(disp, direct),
              "reply differs from a direct engine call")
    print("replies finite and bitwise equal to direct engine calls")
    return launches


def quant_forwards(model, cpu_model, i1, i2):
    """A ``corr_quant`` model's card forward, and the CPU forward fed the
    card's int8 codes and scales.  The card's and the CPU's features
    differ by fp32 rounding, which moves a few codes across a rounding
    boundary and the disparities by far more than FORWARD_TOL; pinning the
    codes leaves fp32 rounding alone to compare.  The error against the
    CPU's own codes is printed."""
    from raftstereo_tpu_torch.ops import quant

    real, codes = quant.quantize_rows, []

    def record(x):
        codes.append(real(x))
        return codes[-1]

    try:
        quant.quantize_rows = record
        card = model(i1.cuda(), i2.cuda(), iters=4)
        pinned = iter([tuple(t.cpu() for t in c) for c in codes])
        quant.quantize_rows = lambda x: next(pinned)
        cpu = cpu_model(i1, i2, iters=4)
    finally:
        quant.quantize_rows = real
    own, _ = cpu_model(i1, i2, iters=4)
    print(f"corr_quant forward low-res card vs cpu with the CPU's own codes "
          f"max_abs_err {float((card[0].cpu() - own).abs().max()):.3e}")
    return card, cpu


def forward_card_vs_cpu(model, rng, torch):
    """The card's forward (kernels) against the CPU forward (plain
    versions) on a small pair: the repo's own reference for the path."""
    cpu_model = copy.deepcopy(model).to("cpu")
    i1 = torch.from_numpy(rng.uniform(0, 255, (1, 64, 96, 3))
                          .astype(np.float32))
    i2 = torch.from_numpy(rng.uniform(0, 255, (1, 64, 96, 3))
                          .astype(np.float32))
    cfg = model.config
    if cfg.corr_quant:
        (lo_g, up_g), (lo_c, up_c) = quant_forwards(model, cpu_model, i1, i2)
    else:
        lo_g, up_g = model(i1.cuda(), i2.cuda(), iters=4)
        lo_c, up_c = cpu_model(i1, i2, iters=4)
    tag = (cfg.corr_implementation + " corr_quant" * cfg.corr_quant
           + " fused encoder" * bool(cfg.fused_encoder) + " ")
    for name, a, b, tol in (("low-res", lo_g.cpu(), lo_c, FORWARD_TOL[0]),
                            ("full-res", up_g.cpu(), up_c, FORWARD_TOL[1])):
        err = float((a - b).abs().max())
        scale = max(1.0, float(b.abs().max()))
        print(f"{tag}forward {name} card vs cpu max_abs_err {err:.3e} "
              f"(tol {tol} x {scale:.3g})")
        check(bool(torch.isfinite(a).all()) and err <= tol * scale,
              f"card {tag}forward differs from the CPU forward ({name}: "
              f"{err})")


def training_wrappers():
    """Every counted kernel wrapper a training step may launch."""
    from raftstereo_tpu_torch.ops import cuda_alt, cuda_vol

    return serving_wrappers() + (cuda_alt.alt_corr_backward,
                                 cuda_vol.vol_lookup_backward)


def train_phase(torch, mcfg, runs, per_step):
    """The training path of ``mcfg`` on ``ShiftStereoDataset`` at the
    recipe shape: one ``train()`` call per ``(last, first)`` in ``runs``,
    each resuming from the previous call's checkpoint.  Every counted
    wrapper must launch exactly ``per_step[name]`` times per step (0 when
    absent).  Returns launches per wrapper name over all runs, the steps'
    wall times (step 1 included) and the peak device memory in GB."""
    from raftstereo_tpu_torch.cli import train as cli_train
    from raftstereo_tpu_torch.config import TrainConfig
    from raftstereo_tpu_torch.data.synthetic import ShiftStereoDataset

    fns = training_wrappers()
    dataset = ShiftStereoDataset(n=2 * TRAIN_BATCH, hw=TRAIN_HW,
                                 max_disp=48.0, seed=0)
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        for last, _ in runs:
            # The loop stops once the step count exceeds num_steps.
            cfg = TrainConfig(name="smoke", batch_size=TRAIN_BATCH,
                              image_size=TRAIN_HW, train_iters=TRAIN_ITERS,
                              num_steps=last - 1, checkpoint_dir=tmp)
            for fn in fns:
                fn.launches = 0
            t0 = time.perf_counter()
            state = cli_train.train(mcfg, cfg, dataset=dataset, num_workers=0,
                                    no_validation=True, device="cuda",
                                    log_dir=os.path.join(tmp, "runs"))
            counts[last] = {fn.__name__: fn.launches for fn in fns}
            print(f"train() {mcfg.corr_implementation}"
                  f"{' fused encoder' * bool(mcfg.fused_encoder)} to step "
                  f"{state.step} in {time.perf_counter() - t0:.1f}s; "
                  f"launches {counts[last]}")
            check(state.step == last, f"train() stopped at step {state.step}"
                                      f", want {last}")
        saved = sorted(os.listdir(os.path.join(tmp, "smoke")))
        # Every call appends its per-step scalars to the run's JSONL
        # stream; a step skipped as non-finite writes no live_loss.
        loss, secs = {}, {}
        with open(os.path.join(tmp, "runs", "metrics.jsonl")) as f:
            for rec in map(json.loads, f):
                if "live_loss" in rec:
                    loss[rec["step"]] = rec["live_loss"]
                if "step_seconds" in rec:
                    secs[rec["step"]] = rec["step_seconds"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for step in sorted(secs):
        print(f"train step {step}: loss {loss.get(step, float('nan')):.6g} "
              f"wall {secs[step]:.3f}s")
    print(f"train peak memory {peak_gb:.2f} GB; checkpoints {saved}")
    steps = list(range(1, runs[-1][0] + 1))
    check(sorted(secs) == steps, f"steps run {sorted(secs)}")
    check(sorted(loss) == steps and all(np.isfinite(v) for v in loss.values()),
          f"non-finite or skipped training steps: {loss}")
    for last, first in runs:
        want = {fn.__name__: (last - first) * per_step.get(fn.__name__, 0)
                for fn in fns}
        check(counts[last] == want, f"steps {first + 1}..{last}: launches "
                                    f"{counts[last]}, want {want}")
    launches = {fn.__name__: sum(counts[last][fn.__name__] for last, _ in runs)
                for fn in fns}
    return launches, [secs[k] for k in steps], peak_gb


def step_batch(rng, torch):
    """A 64x96 training batch: two images, a disparity target, validity."""
    batch = [torch.from_numpy(rng.uniform(0, 255, (1, 64, 96, 3))
                              .astype(np.float32)) for _ in range(2)]
    return batch + [torch.from_numpy(-rng.uniform(1, 30, (1, 64, 96, 1))
                                     .astype(np.float32)),
                    torch.ones(1, 64, 96)]


def train_step_card_vs_cpu(torch, batch, mcfg):
    """One train step's loss and gradients, card (kernels) vs CPU (plain
    versions), flagship widths, 3 iterations, a 64x96 batch."""
    from raftstereo_tpu_torch import RAFTStereo
    from raftstereo_tpu_torch.train.loss import sequence_loss

    model = RAFTStereo(mcfg, device="cuda", seed=1)
    cpu_model = copy.deepcopy(model).to("cpu")
    out = []
    for m, dev in ((model, "cuda"), (cpu_model, "cpu")):
        preds = m(*(t.to(dev) for t in batch[:2]), iters=3, test_mode=False)
        loss, _ = sequence_loss(preds, *(t.to(dev) for t in batch[2:]))
        loss.backward()
        out.append((float(loss.detach()),
                    {k: p.grad.cpu() for k, p in m.named_parameters()}))
    (lg, gg), (lc, gc) = out
    gmax = max(float(t.abs().max()) for t in gc.values())
    gerr = max(float((gg[k] - gc[k]).abs().max()) for k in gc)
    print(f"train step ({mcfg.corr_implementation}"
          f"{', fused encoder' * bool(mcfg.fused_encoder)}) card vs cpu: loss "
          f"{lg:.6g} vs {lc:.6g}; gradient "
          f"max_abs_err {gerr:.3e} (tol {STEP_GRAD_TOL} x {gmax:.3g})")
    check(abs(lg - lc) <= STEP_LOSS_TOL * abs(lc),
          f"train step loss differs card vs CPU: {lg} vs {lc}")
    check(gerr <= STEP_GRAD_TOL * gmax,
          f"train step gradients differ card vs CPU by {gerr}")


def counted_wrappers():
    """Every counted kernel wrapper of the port."""
    from raftstereo_tpu_torch.ops import alt_lookup, norm

    return training_wrappers() + (alt_lookup.alt_corr_taps,
                                  alt_lookup.alt_corr_taps_backward,
                                  norm.in_stats, norm.in_apply)


def launch_counts(fns) -> dict:
    return {fn.__name__: fn.launches for fn in fns}


def op_taps(b, h, w1, widths, k, g, torch):
    """Per-level local taps (B*H, W1, L*K), level-major: the radial
    pattern around a random center (taps 0-4 of each level), random reals
    in [-3, w + 3] (5, 6, 8) and exact integers (7); one tap far outside
    and one NaN."""
    cols = []
    for w in widths:
        t = torch.rand((b * h, w1, k), generator=g) * (w + 6) - 3
        center = torch.rand((b * h, w1, 1), generator=g) * (w + 3) - 2
        t[..., :5] = center + torch.arange(-2.0, 3.0)
        t[..., 7] = torch.floor(t[..., 7])
        cols.append(t)
    taps = torch.cat(cols, dim=-1)
    taps[0, 0, k - 1] = 1e6
    taps[-1, -1, 2] = float("nan")
    return taps.cuda().contiguous()


def taps_columns(taps, widths, k, torch) -> int:
    """Distinct (pixel, level, column) pairs inside the levels that the
    taps weight: the dot products the lookup needs."""
    n = 0
    for lvl, w in enumerate(widths):
        t = taps[..., lvl * k:(lvl + 1) * k]
        ok = (t > -1) & (t < w)
        b0 = torch.floor(torch.where(ok, t, torch.zeros_like(t)))
        cols = torch.cat([b0, b0 + 1], dim=-1)
        inside = torch.cat([ok, ok], dim=-1) & (cols >= 0) & (cols <= w - 1)
        cols, _ = torch.sort(torch.where(inside, cols,
                                         torch.full_like(cols, -1.0)), -1)
        new = torch.ones_like(inside)
        new[..., 1:] = cols[..., 1:] != cols[..., :-1]
        n += int((new & (cols >= 0)).sum())
    return n


def rel_err(got, want, torch) -> float:
    """Largest |got - want| / max(1, |want|) over the finite entries of
    ``want``; non-finite entries must match exactly."""
    got, want = got.float(), want.float()
    ok = torch.isfinite(want)
    check(torch.equal(got[~ok].nan_to_num(7.0), want[~ok].nan_to_num(7.0)),
          "non-finite entries differ from the plain version")
    if not bool(ok.any()):
        return 0.0
    return float(((got[ok] - want[ok]).abs()
                  / want[ok].abs().clamp_min(1.0)).max())


def op_kernel_phase(lo_hw, torch):
    """Rows 3, 4 (general taps) and 8 against their plain versions at the
    op path's shapes, timed: the lookup at the serving pyramid (144 rows of
    240, widths 240/120/60/30, C=256, 36 taps) and the training shape
    (480 rows of 180) in fp32 and at the serving pyramid with bf16 feature
    maps and output; its backward at the training shape; instance norm at
    fnet's first norm of a 576x960 bucket (2x64x288x480) and of the
    training recipe (12x64x160x360) in fp32 and the first in bf16.
    Returns the rows and the op path's inputs."""
    import torch.nn.functional as F

    from raftstereo_tpu_torch.ops import alt_lookup as al
    from raftstereo_tpu_torch.ops import norm
    from raftstereo_tpu_torch.ops.corr import build_corr_state

    g = torch.Generator().manual_seed(5)
    c, levels, k = 256, 4, 9
    bf = torch.bfloat16
    rows, inputs = [], {}

    def randn(*shape):
        return torch.randn(shape, generator=g).cuda()

    shapes = {"op_serve": (1,) + tuple(lo_hw),
              "op_train": (TRAIN_BATCH, TRAIN_HW[0] // 4,
                           TRAIN_HW[1] // 4)}
    for path, dtype, out_dtype in (("op_serve", torch.float32, None),
                                   ("op_train", torch.float32, None),
                                   ("op_serve_bf16", bf, bf)):
        b, h, w = shapes[path.replace("_bf16", "")]
        st = build_corr_state(randn(b, h, w, c), randn(b, h, w, c), levels,
                              corr_dtype=dtype)
        f1 = st.fmap1.reshape(b * h, w, c)
        f2 = st.f2cat.reshape(b * h, -1, c)
        taps = op_taps(b, h, w, st.widths, k, g, torch)
        odt = out_dtype or torch.float32
        inputs[path] = (f1, f2, taps, st.widths, (b, h, w))

        def kern():
            return al.alt_corr_taps(f1, f2, taps, st.widths, odt)

        def plain():
            return al.alt_corr_taps_plain(f1, f2, taps, st.widths, odt)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        check(got.dtype == odt and int(got.isnan().sum()) == 1,
              f"alt_corr_taps ({path}): dtype {got.dtype}, "
              f"{int(got.isnan().sum())} NaN entries (want 1)")
        err = rel_err(got, want, torch)
        tol = BF16_ULP * LOOKUP_BF16_ULPS if odt == bf else TAPS_TOL
        abs_err = float((got.float() - want.float()).nan_to_num().abs().max())
        print(f"alt_corr_taps ({path}, {dims(f1)} x {dims(f2)}, taps "
              f"{dims(taps)}) max_abs_err {abs_err:.3e}, max rel {err:.3e} "
              f"(tol {tol})")
        check(err <= tol, f"alt_corr_taps disagrees with its plain version "
                          f"by {err} ({path})")
        ms, plain_ms = time_ms(kern, 50), time_ms(plain, 5)
        esize = 2 if dtype == bf else 4
        osize = 2 if odt == bf else 4
        nbytes = (esize * (f1.numel() + f2.numel()) + 4 * taps.numel()
                  + osize * got.numel())
        flops = 2 * c * taps_columns(taps, st.widths, k, torch) \
            + 4 * taps.numel()
        bound_ms, bound_by = bound(nbytes, flops)
        print(f"alt_corr_taps ({path}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {bound_ms:.4f} ({bound_by}) [{CARD}]")
        rows.append(dict(name="alt_corr_taps", path=path, route="cuda",
                         source="raftstereo_tpu_torch/csrc/alt_corr_taps.cu",
                         replaces="raftstereo_tpu/ops/pallas_alt.py:77",
                         max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None))
        if path != "op_train":
            continue
        gout = randn(*taps.shape)

        def bwd():
            return al.alt_corr_taps_backward(f1, f2, taps, gout, st.widths)

        def bwd_plain():
            return al.alt_corr_taps_backward_plain(f1, f2, taps, gout,
                                                   st.widths)

        k1, k2, want = bwd(), bwd(), bwd_plain()
        torch.cuda.synchronize()
        check(all(same_bits(a, b_, torch) for a, b_ in zip(k1, k2)),
              "alt_corr_taps_bwd: two calls on the same inputs differ")
        check(all(int(a.isnan().sum()) > 0 for a in k1),
              "alt_corr_taps_bwd: the NaN tap poisoned nothing")
        scale = max(1.0, *(float(p[torch.isfinite(p)].abs().max())
                           for p in want))
        err = max(rel_err(a / scale, p / scale, torch)
                  for a, p in zip(k1, want))
        abs_err = max(float((a - p).nan_to_num().abs().max())
                      for a, p in zip(k1, want))
        print(f"alt_corr_taps_bwd ({path}) max_abs_err {abs_err:.3e}, "
              f"{err:.3e} of the largest (tol {BACKWARD_TOL}); bitwise "
              f"repeatable")
        check(err <= BACKWARD_TOL, f"alt_corr_taps_bwd disagrees with its "
                                   f"plain version by {err}")
        ms, plain_ms = time_ms(bwd, 20), time_ms(bwd_plain, 5)
        nbytes = 4 * (2 * f1.numel() + 2 * f2.numel() + 2 * taps.numel())
        flops = 4 * c * taps_columns(taps, st.widths, k, torch) \
            + 6 * taps.numel()
        bound_ms, bound_by = bound(nbytes, flops)
        print(f"alt_corr_taps_bwd ({path}) ms {ms:.4f} plain_ms "
              f"{plain_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}) [{CARD}]")
        rows.append(dict(name="alt_corr_taps_bwd", path=path, route="cuda",
                         source="raftstereo_tpu_torch/csrc/"
                                "alt_corr_taps_bwd.cu",
                         replaces="raftstereo_tpu/ops/pallas_alt.py:195",
                         max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None))

    for path, shape, dtype in (("op_serve", (2, 64, 288, 480), torch.float32),
                               ("op_train", (12, 64, 160, 360),
                                torch.float32),
                               ("op_serve_bf16", (2, 64, 288, 480), bf)):
        x = (randn(*shape) * 1.5 + 0.4).to(dtype)
        inputs[path] += (x,)
        for relu in (True, False):
            def kern(relu=relu):
                return norm.instance_norm_act(x, relu)

            def plain(relu=relu):
                return norm.in_apply_plain(x, *norm.in_stats_plain(x), relu)

            k1, k2, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            check(torch.equal(k1, k2), "instance_norm: two calls differ")
            err = rel_err(k1, want, torch)
            tol = BF16_ULP if dtype == bf else INORM_TOL
            abs_err = float((k1.float() - want.float()).abs().max())
            print(f"instance_norm ({path}, {dims(x)} {x.dtype}, relu {relu}) "
                  f"max_abs_err {abs_err:.3e}, max rel {err:.3e} (tol {tol});"
                  f" bitwise repeatable")
            check(err <= tol, f"instance_norm disagrees with its plain "
                              f"version by {err} ({path}, relu {relu})")
        mean, rstd = norm.in_stats(x)
        ms, plain_ms = time_ms(kern, 20), time_ms(plain, 5)
        ms_stats = time_ms(lambda: norm.in_stats(x), 20)
        ms_apply = time_ms(lambda: norm.in_apply(x, mean, rstd), 20)
        lib_ms = time_ms(lambda: F.instance_norm(x, eps=1e-5), 20)
        esize = 2 if dtype == bf else 4
        bound_ms, bound_by = bound(2 * esize * x.numel(), 5 * x.numel())
        print(f"instance_norm ({path}) ms {ms:.4f} (stats {ms_stats:.4f}, "
              f"apply {ms_apply:.4f}) plain_ms {plain_ms:.4f} library_ms "
              f"{lib_ms:.4f} (F.instance_norm) bound_ms {bound_ms:.4f} "
              f"({bound_by}) [{CARD}]")
        rows.append(dict(name="instance_norm", path=path, shape=dims(x),
                         route="cuda",
                         source="raftstereo_tpu_torch/csrc/inorm.cu",
                         replaces="raftstereo_tpu/ops/pallas_norm.py:47, :66",
                         max_abs_err=abs_err, ms=ms, ms_stats=ms_stats,
                         ms_apply=ms_apply, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=lib_ms))
    return rows, inputs


def op_path_phase(inputs, torch):
    """The op path: per shape one ``pallas_alt_pyramid_flat`` forward and
    ``.backward()`` (bf16: forward only; its gradient is refused) and one
    ``instance_norm_act`` forward and ``.backward()``; each call launches
    exactly its kernels and no other counted kernel.  Returns launches
    per wrapper name for each path."""
    from raftstereo_tpu_torch.ops import alt_lookup as al
    from raftstereo_tpu_torch.ops import norm

    fns = counted_wrappers()
    by_path = {}
    for path, (f1, f2, taps, widths, (b, h, w), x) in inputs.items():
        bf16 = f1.dtype == torch.bfloat16

        def lookup():
            a, c_ = (t.detach().requires_grad_(not bf16) for t in (f1, f2))
            out = al.pallas_alt_pyramid_flat(
                a, c_, taps.reshape(b, h, w, -1), widths,
                out_dtype=torch.bfloat16 if bf16 else torch.float32)
            if not bf16:
                out.backward(torch.ones_like(out))

        def inorm():
            xr = x.detach().requires_grad_(True)
            y = norm.instance_norm_act(xr, True)
            y.backward(torch.ones_like(y))

        total = dict.fromkeys((fn.__name__ for fn in fns), 0)
        for call, want in ((lookup, dict(alt_corr_taps=1,
                                         alt_corr_taps_backward=int(
                                             not bf16))),
                           (inorm, dict(in_stats=1, in_apply=1))):
            for fn in fns:
                fn.launches = 0
            call()
            torch.cuda.synchronize()
            got = launch_counts(fns)
            expect = {fn.__name__: want.get(fn.__name__, 0) for fn in fns}
            check(got == expect, f"op path {path} {call.__name__}: "
                                 f"launches {got}, want {expect}")
            total = {k: total[k] + got[k] for k in total}
        print(f"op path {path}: launches {total}")
        by_path[path] = total
    return by_path


def op_grads_card_vs_cpu(torch):
    """The op functions' outputs and gradients, card (kernels) vs CPU
    (plain versions), on small shapes: within BACKWARD_TOL of the largest
    CPU value."""
    from raftstereo_tpu_torch.ops import alt_lookup as al
    from raftstereo_tpu_torch.ops import norm

    g = torch.Generator().manual_seed(6)
    f1 = torch.randn((6, 16, 256), generator=g)
    f2 = torch.randn((6, 24, 256), generator=g)
    taps = torch.rand((2, 3, 16, 10), generator=g) * 22 - 3
    cot = torch.randn((2, 3, 16, 10), generator=g)
    x = torch.randn((2, 8, 12, 10), generator=g) + 0.3

    def run(dev):
        a, b = (t.to(dev).clone().requires_grad_(True) for t in (f1, f2))
        out = al.pallas_alt_pyramid_flat(a, b, taps.to(dev), (16, 8))
        (out * cot.to(dev)).sum().backward()
        xr = x.to(dev).clone().requires_grad_(True)
        y = norm.instance_norm_act(xr, True)
        (y * y).sum().backward()
        return [t.detach().cpu() for t in (out, a.grad, b.grad, y, xr.grad)]

    want, got = run("cpu"), run("cuda")
    err = max(float((a - w).abs().max()) / max(1.0, float(w.abs().max()))
              for a, w in zip(got, want))
    print(f"op functions card vs cpu (outputs and gradients): {err:.3e} of "
          f"the largest (tol {BACKWARD_TOL})")
    check(err <= BACKWARD_TOL, f"op functions differ card vs CPU by {err}")


def upstream_state_dict(model) -> dict:
    """``model``'s weights under upstream RAFT-Stereo names: split GRU gate
    convs, the projection norm registered twice, batch-norm counters, the
    DataParallel prefix, in a ``state_dict`` key."""
    import torch

    sd = {}
    for k, v in model.state_dict().items():
        v = v.detach().cpu()
        if ".convzr." in k:
            z, r = (t.clone() for t in torch.chunk(v, 2, dim=0))
            sd[k.replace("convzr", "convz")] = z
            sd[k.replace("convzr", "convr")] = r
            continue
        sd[k] = v.clone()
        if ".downsample.1." in k:
            sd[k.replace(".downsample.1.", ".norm3.")] = v.clone()
        if k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = (
                torch.tensor(0))
    return {"state_dict": {f"module.{k}": v for k, v in sd.items()}}


def eval_phase(torch):
    """The flagship at full width through the evaluation entry points on a
    synthetic KITTI tree (KITTI_PAIRS pairs at KITTI_HW): the ``Evaluator``
    pair by pair on a padded shape the process has not run yet, then
    ``cli.evaluate`` from a ``save_weights`` file and from an upstream
    ``.pth``, ``cli.demo`` plain and tiled; then the lookup and update
    kernels against their plain versions at the evaluation grid.  Returns
    the rows and the launches of the Evaluator's run (each call's, read
    after the counters were set to 0 just before it, summed)."""
    from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig
    from raftstereo_tpu_torch.cli import demo as cli_demo
    from raftstereo_tpu_torch.cli import evaluate as cli_evaluate
    from raftstereo_tpu_torch.data import datasets as tds
    from raftstereo_tpu_torch.data.synthetic import make_learnable_kitti
    from raftstereo_tpu_torch.eval import Evaluator, validate_kitti
    from raftstereo_tpu_torch.eval.tiled import plan_geometry
    from raftstereo_tpu_torch.ops.corr import build_corr_state
    from raftstereo_tpu_torch.train.checkpoint import save_weights

    fns = counted_wrappers()
    per_pair = dict(alt_corr=ITERS, gru_update=ITERS)

    def want(n):
        return {fn.__name__: n * per_pair.get(fn.__name__, 0) for fn in fns}

    def reset():
        for fn in fns:
            fn.launches = 0

    model = RAFTStereo(RAFTStereoConfig(), device="cuda", seed=0)
    cfg = model.config
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "kitti")
        t0 = time.perf_counter()
        make_learnable_kitti(root, n=KITTI_PAIRS, hw=KITTI_HW,
                             rng=np.random.default_rng(3))
        print(f"synthetic KITTI tree: {KITTI_PAIRS} pairs at {KITTI_HW} in "
              f"{time.perf_counter() - t0:.1f}s")

        run = Evaluator(model, iters=ITERS)
        outs, calls = [], []
        measured = dict.fromkeys(want(0), 0)

        class Checked:
            """The Evaluator, with each pair's launches and its output
            held against a direct forward on the padded pair."""

            last_runtime = property(lambda self: run.last_runtime)
            last_included_compile = property(
                lambda self: run.last_included_compile)

            def __call__(self, left, right):
                reset()
                flow = run(left, right)
                got = launch_counts(fns)
                check(got == want(1),
                      f"Evaluator launches {got}, want {want(1)}")
                for k, v in got.items():
                    measured[k] += v
                calls.append((run.last_runtime, run.last_included_compile))
                i1, i2, padder = run.pad(left, right)
                _, up = model(i1, i2, iters=ITERS)
                check(np.array_equal(flow, padder.unpad(up)[0, ..., 0]
                                     .cpu().numpy()),
                      "Evaluator output differs from a direct forward")
                outs.append(flow)
                return flow

        res = validate_kitti(model, iters=ITERS, dataset=tds.KITTI(
            aug_params=None, root=root), evaluator=Checked(), warmup=0)
        check(measured == want(KITTI_PAIRS),
              f"Evaluator run launches {measured}, want {want(KITTI_PAIRS)}")
        (padded,) = run.compiled_shapes
        cold = [1e3 * t for t, first in calls if first]
        warm = [1e3 * t for t, first in calls if not first]
        check(len(cold) == 1 and calls[0][1],
              f"first-call flags {[first for _, first in calls]}")
        print(f"Evaluator: {res}; padded {padded}, launches {measured}")
        print(f"eval per-pair wall (forward + host fetch), first call at "
              f"the padded shape (new to this process): {cold[0]:.3f} ms "
              f"[{CARD}]")
        print(f"eval per-pair wall, the other {len(warm)} pairs: mean "
              f"{statistics.mean(warm):.3f} median "
              f"{statistics.median(warm):.3f} min {min(warm):.3f} max "
              f"{max(warm):.3f} stdev {statistics.stdev(warm):.3f} ms "
              f"[{CARD}]")
        print(f"kitti-fps {res['kitti-fps']:.4f} (pairs 2-{KITTI_PAIRS}, "
              f"{KITTI_HW[0]}x{KITTI_HW[1]}, {ITERS} iterations) [{CARD}]")

        files = {"save_weights": os.path.join(tmp, "w.pt"),
                 "upstream .pth": os.path.join(tmp, "w.pth")}
        save_weights(files["save_weights"], model)
        torch.save(upstream_state_dict(model), files["upstream .pth"])
        results = {}
        for fmt, path in files.items():
            reset()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli_evaluate.main(["--dataset", "kitti", "--dataset_root",
                                        root, "--restore_ckpt", path,
                                        "--valid_iters", str(ITERS)])
            wall = time.perf_counter() - t0
            got = launch_counts(fns)
            cli_res = json.loads(out.getvalue().strip().splitlines()[-1])
            print(f"cli.evaluate from the {fmt} file: {cli_res} in "
                  f"{wall:.1f}s; launches {got}")
            check(rc == 0 and all(np.isfinite(v) for v in cli_res.values()),
                  f"cli.evaluate from the {fmt} file: rc {rc}, {cli_res}")
            check(got == want(KITTI_PAIRS), f"cli.evaluate launches {got}, "
                                            f"want {want(KITTI_PAIRS)}")
            results[fmt] = cli_res
        check(results["save_weights"] == results["upstream .pth"],
              f"EPE/D1 differ between the weight files: {results}")
        check(abs(res["kitti-epe"] - results["save_weights"]["kitti-epe"])
              <= 1e-5 * abs(res["kitti-epe"]), "Evaluator EPE differs from "
                                               "cli.evaluate's")

        img = os.path.join(root, "training", "image_{}", "00000{}_10.png")
        for tiled, pairs in ((False, "[01]"), (True, "2")):
            dest = os.path.join(tmp, "demo_tiled" if tiled else "demo")
            reset()
            rc = cli_demo.main(
                ["--restore_ckpt", files["save_weights"], "-l",
                 img.format(2, pairs), "-r", img.format(3, pairs),
                 "--output_directory", dest, "--save_numpy",
                 "--valid_iters", str(ITERS)]
                + (["--tiled", "--tile_size", *map(str, TILE[0]),
                    "--tile_overlap", str(TILE[1]), "--max_disparity",
                    str(TILE[2])] if tiled else []))
            _, _, ys, xs, _, _ = plan_geometry(*KITTI_HW, *TILE)
            n = len(ys) * len(xs) if tiled else 2
            check(rc == 0 and launch_counts(fns) == want(n),
                  f"cli.demo (tiled {tiled}): rc {rc}, launches "
                  f"{launch_counts(fns)}, want {want(n)}")
            names = sorted(os.listdir(dest))
            print(f"cli.demo (tiled {tiled}{f', {n} tiles' if tiled else ''})"
                  f": {names}")
            for i, stem in enumerate([f"00000{c}_10" for c in pairs.strip(
                    "[]")]):
                disp = np.load(os.path.join(dest, f"{stem}.npy"))
                check(disp.shape == KITTI_HW and bool(np.isfinite(disp).all())
                      and f"{stem}.png" in names,
                      f"cli.demo (tiled {tiled}) {stem}: bad output")
                if not tiled:
                    check(np.array_equal(disp, -outs[i]),
                          f"cli.demo {stem}.npy differs from the Evaluator's "
                          f"output")
            check(not tiled or len(ys) >= 2 <= len(xs),
                  f"the tiled pair runs {len(ys)}x{len(xs)} tiles")
    print("evaluation path: launches exact, outputs finite, bitwise equal "
          "across weight files and to direct forwards")

    # The lookup and the update at the evaluation grid (the padded pair at
    # 1/4 resolution: pyramid widths W/4, W/8, W/16, W/32).
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    h, w = padded[0] // cfg.factor, padded[1] // cfg.factor
    c = model.feature_dim
    state = build_corr_state(randn(1, h, w, c), randn(1, h, w, c),
                             cfg.corr_levels)
    print(f"evaluation grid {h}x{w}, pyramid widths {state.widths}")
    disp = -60.0 * torch.rand((1, h, w), generator=g).to(dev)
    x = (torch.arange(w, device=dev, dtype=torch.float32) + disp).contiguous()
    rows = [lookup_row(state, x, cfg.corr_radius, "eval", torch),
            update_row(model, (h, w), disp, randn, "eval", torch)]
    return rows, {"eval": measured}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "raftstereo_tpu_torch", "csrc")):
        print(f"chip_smoke: no raftstereo_tpu_torch/csrc beside {__file__}; "
              f"run it from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig, ServeConfig
    from raftstereo_tpu_torch.ops import _build
    from raftstereo_tpu_torch.ops.image import BucketPadder

    global CARD
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(CARD)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
    for name, path in sorted(libs.items()):
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    for name in ("gru_update", "enc_conv_tc"):
        build_report(name, libs[name])

    cfg = RAFTStereoConfig(corr_implementation="pallas_alt",
                           gru_backend="fused")
    model = RAFTStereo(cfg, device="cuda", seed=0)
    scfg = ServeConfig(port=0, buckets=(IMAGE_HW,), serve_iters=ITERS)
    bucket = BucketPadder(IMAGE_HW, divis_by=scfg.divis_by,
                          bucket_multiple=scfg.bucket_multiple).bucket_hw
    lo_hw = (bucket[0] // cfg.factor, bucket[1] // cfg.factor)
    print(f"bucket {bucket} -> grid {lo_hw}")
    rows = kernel_phase(model, lo_hw, torch)
    rows += encoder_kernel_phase(model, bucket, torch)
    rows += train_fused_kernel_phase(model, torch)
    rows += volume_kernel_phase(cfg, lo_hw, torch)
    rows += bf16_kernel_phase(model, lo_hw, torch)

    def want(**per_request):
        return {fn.__name__: REQUESTS * per_request.get(fn.__name__, 0)
                for fn in serving_wrappers()}

    def serve_and_check(model, per_request, rng):
        got = serve_phase(model, scfg, pairs, torch)
        check(got == want(**per_request), f"{model.config}: launches {got}, "
                                          f"want {want(**per_request)}")
        if model.config.compute_dtype == "bfloat16":
            bf16_forward_card_vs_cpu(model, rng, torch)
        else:
            forward_card_vs_cpu(model, rng, torch)
        return got

    rng = np.random.default_rng(0)
    pairs = [tuple(rng.uniform(0, 255, IMAGE_HW + (3,)).astype(np.float32)
                   for _ in range(2)) for _ in range(REQUESTS)]
    by_path = {"serve": serve_and_check(
        model, dict(alt_corr=ITERS, gru_update=ITERS), rng)}
    # the smooth-field row times the serving path's lookup
    by_path["serve_smooth"] = by_path["serve"]
    del model
    torch.cuda.empty_cache()

    # The fused encoder stages, then the precomputed-volume backends, then
    # bf16 serving, on the same serving path.  The volume backends' and
    # the bf16 paths' card-vs-CPU pairs come from their own generators:
    # the earlier phases' inputs stay as they were.
    vol_rng, bf16_rng = np.random.default_rng(1), np.random.default_rng(2)
    bf16 = dict(compute_dtype="bfloat16", corr_dtype="bfloat16")
    for path, kw, per_request, r in (
            ("serve_fused", dict(fused_encoder=True),
             dict(FUSED_PER_REQUEST, alt_corr=ITERS, gru_update=ITERS), rng),
            ("serve_pallas", dict(corr_implementation="pallas"),
             dict(vol_lookup=ITERS, gru_update=ITERS), vol_rng),
            ("serve_quant", dict(corr_implementation="auto",
                                 gru_backend="auto", corr_quant=True),
             dict(vol_lookup=ITERS, gru_update=ITERS, int8_corr_volume=1),
             vol_rng),
            ("serve_bf16", bf16, dict(alt_corr=ITERS, gru_update=ITERS),
             bf16_rng),
            ("serve_bf16_xla", dict(bf16, gru_backend="xla"),
             dict(alt_corr_epi=ITERS), bf16_rng)):
        m = RAFTStereo(dataclasses.replace(cfg, **kw), device="cuda", seed=0)
        by_path[path] = serve_and_check(m, per_request, r)
        del m
        torch.cuda.empty_cache()
    for impl in ("reg", "alt"):  # the XLA lookups: plain PyTorch on the card
        forward_card_vs_cpu(RAFTStereo(dataclasses.replace(
            cfg, corr_implementation=impl), device="cuda", seed=0),
            vol_rng, torch)

    torch.cuda.empty_cache()
    batch = step_batch(rng, torch)
    lookup = dict(alt_corr=TRAIN_ITERS, alt_corr_backward=TRAIN_ITERS)
    walls = {}
    for path, impl, fused, runs, per_step in (
            ("train", "pallas_alt", False,
             ((TRAIN_STEPS, 0), (RESUME_TO, TRAIN_STEPS)), lookup),
            ("train_pallas", "pallas", False, ((VOL_STEPS, 0),),
             dict(vol_lookup=TRAIN_ITERS, vol_lookup_backward=TRAIN_ITERS)),
            ("train_fused", "pallas_alt", True, ((FUSED_STEPS, 0),),
             dict(FUSED_PER_STEP, **lookup))):
        mcfg = RAFTStereoConfig(corr_implementation=impl,
                                fused_encoder=fused)
        by_path[path], secs, peak_gb = train_phase(torch, mcfg, runs,
                                                   per_step)
        walls[path] = (statistics.median(secs[1:]), peak_gb)
        train_step_card_vs_cpu(torch, batch, mcfg)
        torch.cuda.empty_cache()
    for path in ("train", "train_fused"):
        print(f"{path}: median step wall (steps 2 on) {walls[path][0]:.3f}s, "
              f"peak memory {walls[path][1]:.2f} GB")

    # The op functions (rows 3, 4 with general taps, 8), then evaluation.
    op_rows, op_inputs = op_kernel_phase(lo_hw, torch)
    rows += op_rows
    by_path.update(op_path_phase(op_inputs, torch))
    del op_inputs
    torch.cuda.empty_cache()
    op_grads_card_vs_cpu(torch)
    eval_rows, eval_launches = eval_phase(torch)
    rows += eval_rows
    by_path.update(eval_launches)

    # Each row's launches are those of its path's run, beside the times
    # and bound measured at that path's shapes.
    for row in rows:
        row["launches"] = by_path[row["path"]][COUNTER.get(row["name"],
                                                           row["name"])]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
