#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, none caught: (1) print the card's name and power limit; (2) build
the CUDA kernels from ``raftstereo_tpu_torch/csrc``, printing ptxas's
registers, shared memory and spills of each tensor-core kernel (row 2's
fused update, ``gru_update.cu``; rows 9, 15 and 16's encoder convs,
``enc_conv_tc.cu``, fp32 only; rows 13 and 12's stems, ``enc_conv.cu``;
rows 9, 15 and 16's bf16 forms, ``enc_conv_wg.cu``, which must spill
nothing) and, where ``cuobjdump`` exists, the count of tensor-core
instructions (HMMA/HGMMA) in each library, which must not be 0
(``enc_conv_wg``: HGMMA only, so the bf16 3x3 convs run no HMMA); (3)
hold each kernel against its
plain PyTorch version on the card at the shapes its main path gives it,
and time both (the tensor-core
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
(fnet's 2 images and cnet's 1 at 576x960, each with its own conv1 row;
layer2 at 288x480), the
stride-2 conv1 at the ``n_downsample=3`` path's shapes (fnet's 2 images
with sums, cnet's 1 without; its row on that path) and the stats kernel
at a batch-3 fnet shape (6 images); the backward and the encoder kernels
also bitwise repeatable; (4) serve three 540x960, 32-iteration requests
of the flagship model through ``/predict``, check that they are finite,
bitwise equal to a direct ``BatchEngine.infer_batch`` call, and that each
serving kernel launched exactly 32 times per request (and no encoder
kernel); (5) the same with ``fused_encoder=True``, whose encoder kernels
must launch exactly their per-request counts, then with
``fused_encoder=True`` and ``n_downsample=3`` (``serve_fused_ds3``: the
stride-2 conv1, row 12, twice a request and the stride-1 one never,
``FUSED_PER_REQUEST_DS3``); (6) hold the card's forward against the
port's CPU forward (plain versions) on a small pair, plain and fused
encoders (and the ``n_downsample=3`` fused model); (7) train the flagship model through
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
cotangents) and the int8 volume, the lookup and the int8 volume also two
calls bitwise equal and on hostile inputs (the lookup on taps that round
across an integer, NaN, +-inf, +-1e30, integers and half-integers, a
zero-width level, radius 0 and 8 levels, a misaligned volume; the int8
volume at C = 16, 48 and 272, W2 = 9 and 130, W1 = 241, codes of +-127
and -128 on every channel, zero scales), the lookup beside its library
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
maps, the serving shapes; the two lookups also, held only, on jumps wider
than the staging buffer) against their plain versions, in bf16 ulps;
(17) serve three requests with bf16 compute and bf16 feature maps through
the fused update (32 bf16 lookups and 32 bf16 updates per request) and
three through the module step (32 fused-convc1 lookups per request, no
other counted kernel), replies bitwise equal to direct engine calls;
(18) hold each bf16 path's card forward against the CPU's with the card's
encoder outputs pinned.  Then the op functions and evaluation: (19) hold
the lookup at caller-given taps (row 3, at the serving pyramid and the
training shape in fp32, and in bf16; two calls bitwise equal), its
general-taps backward (row 4, bitwise repeatable), both also on coherent
taps (smooth centres; row 3 at the serving and training shapes, row 4 at
the training shape) with their outputs' SHA-256 digests printed, row 3's
general form (a warp per pixel; 16 rows of 240 pixels, one 700-wide level,
400 taps a pixel, whose dots outgrow the tiled form's shared memory) held
and timed, and the
stand-alone instance norm (row 8 at a 576x960 bucket's fnet norm and at
the training shape, fp32 and bf16; relu on and off) against their plain
versions, both forms timed (the one-pass cluster form that the op takes
at these shapes and the stats + apply form), and at shapes under the
50 MB L2 cache also with the cache flushed between calls; (20) run the
op path: each ``pallas_alt_pyramid_flat`` forward and backward launches
exactly one row 3 and one row 4 kernel, each ``instance_norm_act``
forward and backward one cluster kernel, and gradients match the CPU's
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
evaluation grid (96x312, pyramid widths 312/156/78/39), timed.  bf16
training (``compute_dtype="bfloat16"``): (23) hold row 4's bf16 forms
against their plain versions, in bf16 ulps with the share of equal
elements, two calls bitwise equal, SHA-256 digests printed, timed: the
radial form at the training path's shapes (6x80x180 bf16 feature maps,
a bf16 cotangent; random and smooth disparities; infinite cotangents
held) and the general form at the op-train shape (480x180, 36 taps,
random and smooth taps; the bf16 op path's backward also launches it);
(24) train 3 steps of the recipe with bf16 compute and bf16 feature maps
(``train_bf16``): 16 lookups and 16 backward lookups a step, finite
losses, step walls and peak memory beside the fp32 training path's; (25)
one 64x96 bf16 step card vs CPU for each correlation dtype, the card's
encoder outputs pinned in both, within a share of the CPU's
bf16-vs-fp32 distance.  Then the accuracy tiers
(``compute_dtype``/``corr_dtype`` bf16 with the ``pallas`` volume, and
``corr_quant``, the int8 tier): (26) hold rows 5 and 7's bf16 forms
against their plain versions, bitwise, timed: row 7 with a bf16 volume at
the serving shape (``serve_turbo``), row 5 over the bf16 volume pyramid
at the serving shape on the random and smooth fields
(``serve_bf16_pallas``, ``serve_bf16_pallas_smooth``; the jump field
held), over the int8 tier's pyramid (``serve_turbo``) and at the
training op shape (``op_vol_bf16``, one counted launch a lookup), both
also on hostile inputs (bf16 rows at every 2-byte shift, ragged int8
tiles); (27) serve three requests on each of ``serve_bf16_pallas`` (32
bf16 volume lookups and 32 updates a request) and ``serve_turbo`` (one
bf16 int8 volume, 32 lookups, 32 updates), bitwise equal to direct engine
calls, and hold each card forward against the CPU's with the encoder
outputs (and the int8 codes) pinned; (28) certify the ``fast`` and
``turbo`` tiers of the fp32 flagship with ``cli.certify`` on the card
(explicit bounds, ``TIER_BOUNDS``; the measured deltas printed), then
serve them with ``--tiers certified fast turbo --cert_manifest``: three
requests each with no ``accuracy`` and with each tier, every reply
bitwise equal to a direct engine call in its mode (no ``accuracy`` and
``certified`` to the base model's), each tier's launches exact
(``TIER_PER_REQUEST``), each tier's ``meta.latency_ms`` printed; an
unknown tier and a tier held over its bound by a second manifest are
400s.  Then the fused encoder in bf16 (``fused_encoder=True`` with bf16
compute and feature maps: the fast and turbo tiers on a fused base):
(29) hold the bf16 forms of rows 13, 9, 11, 15, 16 and 17 at the fused
serving shapes (fnet's 2 images with sums, cnet's 1 without; row 9 in
its prep and residual forms, row 16 in its prep and residual-projection
forms; rows 9, 15 and 16 on ``enc_conv_wg.cu``), rows 12 and 9 at the
``n_downsample=3`` shapes and row 10 at a batch-3 fnet against their
bf16 plain versions (within 1 bf16 ulp with 99.5% of the elements equal,
the sums within ENC_TOL, the finishes bitwise; two calls bitwise
equal), timed beside the plain versions, ``F.conv2d`` on
bf16 tensors and ``torch.var_mean``; (30) serve three requests on each of
``serve_fused_bf16`` and ``serve_fused_ds3_bf16``: launches exact (the
encoder kernels' ``FUSED_PER_REQUEST`` or ``_DS3`` plus 32 lookups and 32
updates), replies bitwise equal to direct engine calls, the card's
fused trunks (stem + layer1 + layer2) within FUSED_TRUNK_TOL of the
CPU's (fnet's limits closer than the CPU's plain bf16 encoders' trunks
in the same run), the encoder outputs (fmap, net, inp) within
FUSED_ENC_CARD_ULPS of the CPU's and the disparity with the encoders
pinned within 1.0 / 1.5 px; (31)
phase 28 again on a ``fused_encoder=True`` base (``cli.certify
--fused_encoder``): ``fast`` and ``turbo`` advertised, their models fused
and bf16, every reply bitwise a direct engine call, each tier's launches
its ``TIER_PER_REQUEST`` plus the encoder kernels'.  Then bf16
training through the fused encoder and on the bf16 ``pallas`` volume:
(32) hold the bf16 forms of the kernels that the bf16 fused training
path launches at its shapes (fnet's 12 images of 320x720, layer2 at
160x360; cnet's 6 images without sums held): row 14's bf16 form (the
stage backward's dual sums of two bf16 tensors, within DUAL_TOL, bitwise
repeatable) and rows 10, 9, 11, 15, 16 and 17 in bf16, timed beside
their plain versions and one library call each; (33) train 3 steps of
the recipe on each of ``train_fused_bf16`` (``fused_encoder=True`` with
bf16 compute and feature maps: ``FUSED_PER_STEP``, 5 bf16 dual sums
among them, and the bf16 lookup pair a step) and ``train_bf16_pallas``
(the bf16 volume: 16 lookups and 16 backward lookups a step), step walls
and peak memory beside the other training paths'; one 64x96 bf16 step
card vs CPU for each (the fused one at both correlation dtypes).  Every
bf16 step card vs CPU pins the encoders' outputs with their gradients
flowing through the encoders, whose parameter gradients join the held
gradients.  Prints
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
import hashlib
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
import urllib.error
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
L2_BYTES = 50e6  # the H100's L2 cache; time_cold_ms writes 128 MB between calls
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
# and the stats kernel at batch 1.  With n_downsample=3 conv1 is the
# stride-2 one (row 12) for both encoders, the rest as before.
FUSED_PER_REQUEST = {"stem_conv7": 2, "stem_conv7_s2": 0, "stage_conv": 8,
                     "plane_stats": 0, "stage_finish": 2, "l2_entry": 2,
                     "l2_conv": 6, "l2_finish": 2}
FUSED_PER_REQUEST_DS3 = dict(FUSED_PER_REQUEST, stem_conv7=0,
                             stem_conv7_s2=2)
# Per-step launches of the fused encoder kernels on the training path at
# the recipe (fnet 12 images, cnet 6: more than the fused conv1 takes, so
# conv1 runs in cuDNN, fnet's stage takes its first sums from the stats
# kernel, and the instance-norm stage backward takes its five dual sums,
# for dc21, dc20, dc11, dc10 and dy1; cnet's frozen-BN backward takes none).
# The bf16 fused path (train_fused_bf16) launches the same kernels in their
# bf16 forms.
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
# The bf16 fused trunks (stem + layer1 + layer2: what the encoder kernels
# compute), card vs CPU on the 64x96 pair (fused_trunks_card_vs_cpu), per
# encoder: (max bf16 ulps of max(1, |cpu|), least share of elements
# equal, whether both must lie closer than the CPU's plain bf16 encoders'
# trunks in the same run).  Measured (NVIDIA H100 80GB HBM3, 700.00 W; 3
# seeds at n_downsample 2 and 3; scripts/fused_enc_readings.py): fnet card
# 5.0-7.0 ulps, 58-72% equal, against plain-vs-fused 15.5-18.0 ulps, 29%
# equal: its limits tell the fused stages from the plain encoders in
# every run.  cnet (frozen batch norm: no sums spread a flip over a
# channel) card 1.0-1.9 ulps, 88-95% equal, against plain 1.0-1.8 ulps,
# 92-99%: its plain encoder rounds as closely to the fused one, so there
# only the launch counts tell them apart; held to twice the largest, 0.8.
FUSED_TRUNK_TOL = {"fnet": (10.0, 0.45, True), "cnet": (4.0, 0.8, False)}
# The whole encoders' outputs, card vs CPU (fused_encoders_card_vs_cpu):
# fnet's fmap 8.5-10.0 ulps (the same script and run; 13.0 on the
# smoke's own pair), against the CPU plain encoder's 19.5-25.7; cnet's
# net and inp heads 5.0-20.5 ulps against plain 3.9-15.0.  The plain
# bf16 modules after the trunk (layer3, layer4, the heads), shared by
# both, spread these readings, so the fused stages are told from the
# plain encoders on the trunks above; the outputs are held to about
# 1.5x the largest reading.
FUSED_ENC_CARD_ULPS = 32.0
# Rows 3, 4 (general taps) and 8 against their plain versions: the lookup
# in fp32 within 1e-5 of max(1, |plain|) (dots of length 256 summed in
# another order), with a bf16 output within one bf16 ulp; the backward
# within BACKWARD_TOL of the largest gradient; instance norm within 1e-5
# of max(1, |plain|) in fp32 (plane sums of up to 138,240 values in
# another order) and one bf16 ulp in bf16.
TAPS_TOL, INORM_TOL = 1e-5, 1e-5
# bf16 training (``compute_dtype="bfloat16"``).  Row 4's bf16 forms
# (radial and general taps) against their plain versions: within one bf16
# ulp of max(1, |plain|) per element (the coefficient's fp32 sum and the
# products' fp32 sums in another order round to the same bf16 value but
# at a boundary), and at least 99% of the elements equal.
BWD_BF16_ULPS, BWD_BF16_EQUAL = 1.0, 0.99
TRAIN_BF16_STEPS = 3
# The bf16 step, card vs CPU with the encoders pinned (64x96, flagship
# widths, 3 iterations): the loss within 5e-3 relative, and the
# predictions, all gradients and encoder-output cotangents each
# at most 0.7 of the CPU's bf16-vs-fp32 distance (2-norms).  On the CPU,
# the same step with its bf16 convs summed in another order (exact
# products, fp32 sums: as cuDNN's differ from oneDNN's) moved the loss by
# 1.1e-4-1.6e-3 and sat at 0.13-0.43 of that distance, over three seeds
# and both correlation dtypes.
BF16_STEP_LOSS_TOL, BF16_STEP_SHARE = 5e-3, 0.7
# The accuracy tiers: certification on the synthetic set at the JAX
# package's defaults (256x320, 4 pairs, 16 iterations), with explicit
# bounds: the smoke's random-weight flagship diverges (PERF.md section 5),
# so its deltas may exceed the JAX package's DEFAULT_BOUNDS (fast 0.5 px,
# turbo 1.0 px), which are for trained weights.  What the gate does is
# shown by a second manifest that holds turbo over its bound.  Per-request
# launches of each tier on the fp32 pallas_alt + fused-update base.
TIER_CERT = ((256, 320), 4, 16)
TIER_BOUNDS = {"fast": 1000.0, "turbo": 1000.0}
TIER_PER_REQUEST = {
    "default": dict(alt_corr=ITERS, gru_update=ITERS),
    "certified": dict(alt_corr=ITERS, gru_update=ITERS),
    "fast": dict(alt_corr=ITERS, gru_update=ITERS),
    "turbo": dict(int8_corr_volume=1, vol_lookup=ITERS, gru_update=ITERS)}
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
           "instance_norm": "in_norm_cluster"}


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


def time_cold_ms(fn, reps: int = 10) -> float:
    """Device time of one ``fn()`` call in ms with the L2 cache flushed
    before it (128 MB written between calls): CUDA events around each call
    alone, behind a short sleep kernel that holds the stream while the
    host enqueues it; the median of ``reps`` calls, after one warm-up."""
    import torch

    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for i in range(reps):
        flush.fill_(float(i))
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(SLEEP_CYCLES // 10)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
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


def post_tier(port: int, left: np.ndarray, right: np.ndarray,
              accuracy=None):
    """``/predict`` with an optional ``accuracy`` tier: (status, reply)."""
    def arr(a):
        return {"shape": list(a.shape), "dtype": "float32",
                "data_b64": base64.b64encode(a.tobytes()).decode("ascii")}

    obj = {"left": arr(left), "right": arr(right), "iters": ITERS}
    if accuracy is not None:
        obj["accuracy"] = accuracy
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=json.dumps(obj).encode(),
                                 method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


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
                     r"enc_conv_tc_kernel|stem7_tc_kernel|"
                     r"stem7_bf16_kernel|enc_conv_wg_kernel)I(.*?)EEv",
                     mangled)
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
    else 3, and a barrier per stage; rows 9, 15 and 16's fp32
    ``enc_conv_tc_kernel<stride,mode,projection,MT,NT>``'s and rows 13
    and 12's ``stem7_tc_kernel<stride>``'s and ``stem7_bf16_kernel``'s,
    and rows 9, 15 and 16's bf16
    ``enc_conv_wg_kernel<stride,mode,projection,k-steps,N,MR>``'s are set
    at launch), and the tensor-core instructions in the library, which
    must not be 0.  ``enc_conv_tc`` must hold fp32 kernels only;
    ``enc_conv_wg``, the `wgmma` conv, must spill nothing and hold HGMMA
    and no HMMA instructions."""
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
            if name == "enc_conv_wg":
                check(re.search(r"\b0 bytes spill stores, 0 bytes spill "
                                r"loads", spill or "") is not None,
                      f"{entry} spills: {spill}")
            if name == "enc_conv_tc":
                check("bf16" not in entry, f"{name}: a bf16 kernel {entry}")
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
    if name == "enc_conv_wg":
        check(hgmma > 0 and hmma == 0, f"{name}: {hmma} HMMA, {hgmma} HGMMA "
                                       f"(want wgmma only)")


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

    inf_cotangent_hold(state, x, gout, r, torch)
    return rows


def inf_cotangent_hold(state, x, gout, r, torch):
    """Row 4 radial on infinite cotangents: the dense hat's +-inf on the
    columns their taps weight, NaN on the level's others and on the
    pixel's df1, exactly where plain has them; within BACKWARD_TOL of
    max(1, |plain|) elsewhere (fp32 maps), or one bf16 ulp (bf16)."""
    from raftstereo_tpu_torch.ops import cuda_alt

    k = 2 * r + 1
    xi, gi = x.clone(), gout.clone()
    xi[0, 5, 40], xi[1, 7, 90] = 80.5, 33.0   # level 1: x_l 40.25, 16.5
    gi[0, 5, 40, k] = float("inf")            # level 1, tap 0
    gi[1, 7, 90, k + r] = -float("inf")       # level 1, the middle tap
    got = cuda_alt.alt_corr_backward(state.fmap1, state.f2cat, state.widths,
                                     xi, gi, r)
    want = cuda_alt.alt_corr_backward_plain(state.fmap1, state.f2cat,
                                            state.widths, xi, gi, r)
    torch.cuda.synchronize()
    bf16 = state.fmap1.dtype == torch.bfloat16
    for name, a, w in zip(("df1", "df2"), got, want):
        inf, ok = w.isinf(), torch.isfinite(w)
        same = (torch.equal(a.isnan(), w.isnan())
                and torch.equal(a.isinf(), inf)
                and torch.equal(a[inf], w[inf]))
        if bf16:
            err, tol = ulps(a[ok], w[ok]), BWD_BF16_ULPS
            unit = " bf16 ulps"
        else:
            err = float((a[ok] - w[ok]).abs().max())
            tol, unit = BACKWARD_TOL * max(1.0, float(w[ok].abs().max())), ""
        print(f"alt_corr_bwd {a.dtype} (infinite cotangents) {name}: NaN "
              f"and +-inf where plain has them: {same} "
              f"({int(w.isnan().sum())} NaN, {int(inf.sum())} inf); "
              f"max error {err:.3e}{unit} elsewhere")
        check(same and err <= tol,
              f"alt_corr_bwd's non-finite {name} differs from plain's")
    check(bool(got[1].isinf().any()), "alt_corr_bwd: no +-inf column")


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


def epi_hold(state, x, r, ew, eb, label, torch):
    """The lookup with convc1 fused against its plain version on x, timed,
    with no row: within EPI_ULPS, two calls bitwise equal."""
    from raftstereo_tpu_torch.ops import cuda_alt

    def kern():
        return cuda_alt.alt_corr_epi(state.fmap1, state.f2cat, state.widths,
                                     x, r, ew, eb)

    got, again = kern(), kern()
    want = cuda_alt.alt_corr_epi_plain(state.fmap1, state.f2cat,
                                       state.widths, x, r, ew, eb)
    torch.cuda.synchronize()
    err = ulps(got, want)
    ms = time_ms(kern, 50)
    print(f"alt_corr_epi ({label}, {dims(x)}, {state.fmap1.dtype}) err "
          f"{err:.3f} bf16 ulps (tol {EPI_ULPS}) ms {ms:.4f} [{CARD}]")
    check(torch.equal(got, again), f"alt_corr_epi: two calls on the {label}"
                                   f" field differ")
    check(err <= EPI_ULPS, f"alt_corr_epi disagrees with its plain version "
                           f"by {err} bf16 ulps on the {label} field")


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


# The source of each encoder row under csrc/ (enc_conv where not listed),
# and of its bf16 form where that differs (rows 9, 15 and 16: the wgmma
# conv).
ENCODER_SOURCES = {"stage_conv": "enc_conv_tc", "l2_entry": "enc_conv_tc",
                   "l2_conv": "enc_conv_tc",
                   "stage_finish": "enc_finish", "l2_finish": "enc_finish",
                   "plane_stats": "enc_stats", "dual_sums": "enc_stats"}
ENCODER_BF16_SOURCES = {**ENCODER_SOURCES, "stage_conv": "enc_conv_wg",
                        "l2_entry": "enc_conv_wg", "l2_conv": "enc_conv_wg"}


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
    ``n_downsample=3`` path's shapes (its row on ``serve_fused_ds3``) and
    the stats kernel at a batch-3 fnet; one timed row per kernel."""
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
        lib=lambda: F.conv2d(img, w1, b1, 1, 3), reps=10,
        products=conv_products(w1, out))
    img1 = img[:1].contiguous()  # cnet's image: batch 1, no sums
    row("stem_conv7", "raftstereo_tpu/ops/pallas_encoder.py:648",
        f"{dims(img1)} no sums",
        lambda: ce.stem_conv7(img1, w1, b1, want_stats=False),
        lambda: ce.conv_plain(img1, w1, b1, 1, want_stats=False), 1.0,
        ENC_TOL, 4 * (img1.numel() + w1.numel() + 64 + out // 2),
        conv_products(w1, out // 2) + out // 2,  # the products, the bias
        lib=lambda: F.conv2d(img1, w1, b1, 1, 3), reps=10,
        products=conv_products(w1, out // 2))
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

    # -- cnet, 1 image, batch norm: the same kernels without sums (conv1's
    # row is above)
    x1, t1 = x[:1].contiguous(), t[:1].contiguous()
    ab = aff(1, 64)
    for label, kern, plain in (
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

    # -- the n_downsample=3 path: the stride-2 conv1 (row 12), fnet's 2
    # images with sums (timed) and cnet's 1 without (held)
    outs2 = 2 * 64 * h2 * w2
    enc_row(rows, "serve_fused_ds3", "stem_conv7_s2",
            "raftstereo_tpu/ops/pallas_encoder.py:721",
            f"{dims(img)} (n_downsample=3)",
            lambda: ce.stem_conv7_s2(img, w1, b1),
            lambda: ce.conv_plain(img, w1, b1, 2), n2, ENC_TOL,
            4 * (img.numel() + w1.numel() + 64 + outs2 + 2 * 2 * 64),
            conv_cost(img, w1, outs2, n_in=0), torch,
            lib=lambda: F.conv2d(img, w1, b1, 2, 3), reps=10,
            products=conv_products(w1, outs2))
    hold(f"stem_conv7_s2 {dims(img1)} no sums (n_downsample=3)",
         lambda: ce.stem_conv7_s2(img1, w1, b1, want_stats=False),
         lambda: ce.conv_plain(img1, w1, b1, 2, want_stats=False), 1.0,
         ENC_TOL, torch)
    # -- off the batch-1 path: the stats kernel (row 10) at a batch-3 fnet
    big = randn(6, 64, h, w)
    row("plane_stats", "raftstereo_tpu/ops/pallas_norm.py:47 (via "
        "pallas_encoder.py:476)", f"{dims(big)} (batch 3)",
        lambda: ce.plane_stats(big), lambda: ce.stats_plain(big), n,
        ENC_TOL, 4 * (big.numel() + 2 * 6 * 64), 3 * big.numel(),
        lib=lambda: torch.var_mean(big, dim=(2, 3), correction=0), reps=10)
    return rows


# The fused encoder's bf16 forms against their bf16 plain versions: a
# convolution's exact bf16 products summed in fp32 in another order round
# to the other bf16 neighbour at a boundary (1 ulp of max(1, |plain|), at
# least 99.5% of the elements equal; the fp32 output sums within ENC_TOL
# per pixel); the finishes round each op as plain does (bitwise).
ENC_BF16_ULPS, ENC_BF16_EQUAL = 1.0, 0.995


def enc_bf16_row(rows, path, name, replaces, path_shape, kern, plain, n,
                 nbytes, flops, torch, lib=None, reps=5, products=0,
                 exact=False):
    """A bf16 encoder kernel held against its bf16 plain version (two
    calls bitwise equal; bf16 outputs within ENC_BF16_ULPS with
    ENC_BF16_EQUAL of them equal, or bitwise where ``exact``; fp32 (B, C)
    sums within ENC_TOL per pixel, divided by ``n``) and timed beside it
    and ``lib``; appends its row for ``path``: ``max_bf16_ulps`` and
    ``equal_share`` of its first bf16 output, ``sums_max_rel`` the largest
    relative sums error per pixel, each null where the kernel has no such
    output (row 10 has no bf16 output).  ``products`` of the ``flops`` run
    on the bf16 tensor cores (``bound_ms``), the rest on the CUDA cores.
    Without ``nbytes`` it is held only."""
    bf = torch.bfloat16
    k1, k2, want = kern(), kern(), plain()
    torch.cuda.synchronize()
    k1, k2, want = _leaves(k1), _leaves(k2), _leaves(want)
    check(len(k1) == len(want), f"{name}: {len(k1)} outputs vs {len(want)}")
    check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
          f"{name} {path_shape}: two calls on the same inputs differ")
    err = equal = rel = None  # set only from this kernel's outputs
    for i, (a, w) in enumerate(zip(k1, want)):
        check(a.dtype == w.dtype, f"{name}: dtype {a.dtype} vs {w.dtype}")
        if a.dtype == bf:
            u, eq = ulps(a, w), float((a == w).float().mean())
            if i == 0:
                err, equal = u, eq
            check(torch.equal(a, w) if exact else
                  (u <= ENC_BF16_ULPS and eq >= ENC_BF16_EQUAL),
                  f"{name} {path_shape}: {u} bf16 ulps, {eq} of elements "
                  f"equal to plain")
        else:
            d = float(((a - w) / n).abs().max())
            r = d / max(1.0, float((w / n).abs().max()))
            rel = r if rel is None else max(rel, r)
            check(r <= ENC_TOL, f"{name} {path_shape}: sums {r}")
    abs_err = float((k1[0].float() - want[0].float()).abs().max())
    held = [f"max {err:.3f} bf16 ulps, {equal:.5f} of elements equal"
            f"{' (bitwise)' if exact else ''}"] if err is not None else []
    held += [f"sums max rel/pixel {rel:.3e}"] if rel is not None else []
    print(f"{name} {path_shape} bf16: {', '.join(held)} (tol "
          f"{ENC_BF16_ULPS} ulps, {ENC_BF16_EQUAL} equal, {ENC_TOL}); "
          f"bitwise repeatable")
    if nbytes is None:
        return
    ms, plain_ms = time_ms(kern, reps), time_ms(plain, reps)
    lib_ms = time_ms(lib, reps) if lib is not None else None
    bound_ms, bound_by = bound(nbytes, flops - products, bf16_flops=products)
    print(f"{name} {path_shape} bf16 ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {lib_ms} bound_ms {bound_ms:.4f} ({bound_by}"
          f"{', bf16 tensor cores' if products else ''}) [{CARD}]")
    src = ENCODER_BF16_SOURCES.get(name, "enc_conv")
    rows.append(dict(name=name, path=path, shape=f"{path_shape} bf16",
                     route="cuda",
                     source=f"raftstereo_tpu_torch/csrc/{src}.cu",
                     replaces=replaces, max_abs_err=abs_err,
                     max_bf16_ulps=err, equal_share=equal,
                     sums_max_rel=rel, ms=ms,
                     plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=lib_ms))


def encoder_bf16_kernel_phase(model, bucket, torch):
    """The fused encoder kernels' bf16 forms against their bf16 plain
    versions at the bf16 fused serving path's shapes (``serve_fused_bf16``:
    fnet 2 images with sums, cnet 1 image without; layer2 at 288x480), row
    12 at the ``n_downsample=3`` path's (``serve_fused_ds3_bf16``) and row
    10 at a batch-3 fnet (6 images); one timed row per kernel, beside
    ``F.conv2d`` on bf16 tensors (cuDNN) and ``torch.var_mean``."""
    import torch.nn.functional as F

    from raftstereo_tpu_torch.ops import cuda_encoder as ce

    dev = torch.device("cuda")
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(18)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    def aff(b, c):  # fp32; shifts > 0: padding before the prep would show
        return ((0.5 + torch.rand((b, c), generator=g)).to(dev),
                (0.5 * torch.rand((b, c), generator=g)).to(dev))

    def wb(m):
        return m.weight.detach(), m.bias.detach()

    def wb16(m):
        return m.weight.detach().to(bf), m.bias.detach().to(bf)

    enc = model.fnet
    l0, l1 = enc.layer1
    m0, _ = enc.layer2
    h, w = bucket
    h2, w2 = h // 2, w // 2
    rows = []
    path = "serve_fused_bf16"

    def row(*args, **kw):
        enc_bf16_row(rows, path, *args, torch=torch, **kw)

    # -- fnet, 2 images: conv1 (row 13), layer1 (row 9), finish (row 11)
    img = torch.tanh(randn(2, 3, h, w)).to(bf)
    w1, b1 = wb(enc.conv1)
    w1h, b1h = wb16(enc.conv1)
    n = float(h * w)
    out = 2 * 64 * h * w
    row("stem_conv7", "raftstereo_tpu/ops/pallas_encoder.py:648",
        dims(img), lambda: ce.stem_conv7(img, w1, b1),
        lambda: ce.conv_plain(img, w1, b1, 1), n,
        2 * (img.numel() + w1.numel() + 64 + out) + 4 * 2 * 2 * 64,
        conv_cost(img, w1, out, n_in=0),
        lib=lambda: F.conv2d(img, w1h, b1h, 1, 3), reps=10,
        products=conv_products(w1, out))
    img1 = img[:1].contiguous()  # cnet's image: no sums
    row("stem_conv7", "raftstereo_tpu/ops/pallas_encoder.py:648",
        f"{dims(img1)} no sums",
        lambda: ce.stem_conv7(img1, w1, b1, want_stats=False),
        lambda: ce.conv_plain(img1, w1, b1, 1, want_stats=False), 1.0, None,
        0)
    x = randn(2, 64, h, w).to(bf)
    r = randn(2, 64, h, w).to(bf)
    a, ra = aff(2, 64), aff(2, 64)
    wc, bc = wb(l0.conv1)
    wch, bch = wb16(l0.conv1)
    row("stage_conv", "raftstereo_tpu/ops/pallas_encoder.py:348",
        f"{dims(x)} res form",
        lambda: ce.stage_conv(x, a, wc, bc, res=r, res_aff=ra),
        lambda: ce.conv_plain(x, wc, bc, 1, a, r, ra), n, None, 0)
    row("stage_conv", "raftstereo_tpu/ops/pallas_encoder.py:338, :348",
        dims(x), lambda: ce.stage_conv(x, a, wc, bc),
        lambda: ce.conv_plain(x, wc, bc, 1, a), n,
        2 * (2 * x.numel() + wc.numel() + 64) + 4 * (2 * 2 * 64 + 2 * 2 * 64),
        conv_cost(x, wc, x.numel(), n_in=1),
        lib=lambda: F.conv2d(x, wch, bch, 1, 1),
        products=conv_products(wc, x.numel()))
    c = randn(2, 64, h, w).to(bf)
    a2, a3 = aff(2, 64), aff(2, 64)
    row("stage_finish", "raftstereo_tpu/ops/pallas_encoder.py:364",
        dims(x), lambda: ce.stage_finish(x, a, r, a2, c, a3),
        lambda: ce.finish_plain(x, a, r, a2, c, a3), n,
        2 * 4 * x.numel() + 4 * 6 * 2 * 64, 12 * x.numel(), reps=20,
        exact=True)

    # -- fnet layer2: entry (row 15), convs (row 16), finish (row 17)
    t = torch.relu(x)
    we, be = wb(m0.conv1)
    wp, bp = wb(m0.downsample[0])
    weh, beh = wb16(m0.conv1)
    n2 = float(h2 * w2)
    out2 = 2 * 96 * h2 * w2
    row("l2_entry", "raftstereo_tpu/ops/pallas_layer2.py:118",
        dims(t), lambda: ce.l2_entry(t, we, be, wp, bp),
        lambda: ce.entry_plain(t, we, be, wp, bp), n2,
        2 * (t.numel() + we.numel() + wp.numel() + 2 * 96 + 2 * out2)
        + 4 * 2 * 2 * 2 * 96,
        conv_cost(t, we, out2, n_in=0, proj_flops=2 * out2 * 64) + 4 * out2,
        lib=lambda: F.conv2d(t, weh, beh, 2, 1),
        products=conv_products(we, out2, proj_flops=2 * out2 * 64))
    y = randn(2, 96, h2, w2).to(bf)
    p = randn(2, 96, h2, w2).to(bf)
    b_, pb = aff(2, 96), aff(2, 96)
    wl, bl = wb(m0.conv2)
    wlh, blh = wb16(m0.conv2)
    row("l2_conv", "raftstereo_tpu/ops/pallas_layer2.py:212",
        f"{dims(y)} res_proj form",
        lambda: ce.l2_conv(y, b_, wl, bl, res=p, res_aff=pb),
        lambda: ce.conv_plain(y, wl, bl, 1, b_, p, pb, res_relu=False), n2,
        None, 0)
    row("l2_conv", "raftstereo_tpu/ops/pallas_layer2.py:201, :212",
        dims(y), lambda: ce.l2_conv(y, b_, wl, bl),
        lambda: ce.conv_plain(y, wl, bl, 1, b_), n2,
        2 * (2 * y.numel() + wl.numel() + 96) + 4 * 4 * 2 * 96,
        conv_cost(y, wl, y.numel(), n_in=1),
        lib=lambda: F.conv2d(y, wlh, blh, 1, 1),
        products=conv_products(wl, y.numel()))
    q, a4 = randn(2, 96, h2, w2).to(bf), aff(2, 96)
    row("l2_finish", "raftstereo_tpu/ops/pallas_layer2.py:228",
        dims(y), lambda: ce.l2_finish(p, pb, y, b_, q, a4),
        lambda: ce.finish_plain(p, pb, y, b_, q, a4, a_relu=False), n2,
        2 * 4 * y.numel() + 4 * 6 * 2 * 96, 12 * y.numel(), reps=20,
        exact=True)

    # -- cnet, 1 image, batch norm: the same kernels without sums
    x1, t1 = x[:1].contiguous(), t[:1].contiguous()
    y1, p1 = y[:1].contiguous(), p[:1].contiguous()
    ab, b1_, pb1 = aff(1, 64), aff(1, 96), aff(1, 96)
    row("stage_conv", "", f"{dims(x1)} no sums",
        lambda: ce.stage_conv(x1, ab, wc, bc, want_stats=False),
        lambda: ce.conv_plain(x1, wc, bc, 1, ab, want_stats=False), 1.0,
        None, 0)
    row("l2_entry", "", f"{dims(t1)} no sums",
        lambda: ce.l2_entry(t1, we, be, wp, bp, want_stats=False),
        lambda: ce.entry_plain(t1, we, be, wp, bp, want_stats=False), 1.0,
        None, 0)
    row("l2_conv", "", f"{dims(y1)} res_proj form no sums",
        lambda: ce.l2_conv(y1, b1_, wl, bl, res=p1, res_aff=pb1,
                           want_stats=False),
        lambda: ce.conv_plain(y1, wl, bl, 1, b1_, p1, pb1, res_relu=False,
                              want_stats=False), 1.0, None, 0)
    row("l2_conv", "", f"{dims(y1)} no sums",
        lambda: ce.l2_conv(y1, b1_, wl, bl, want_stats=False),
        lambda: ce.conv_plain(y1, wl, bl, 1, b1_, want_stats=False), 1.0,
        None, 0)

    # -- the n_downsample=3 path: the stride-2 conv1 (row 12), fnet's 2
    # images with sums (timed) and cnet's 1 without (held)
    path = "serve_fused_ds3_bf16"
    outs2 = 2 * 64 * h2 * w2
    row("stem_conv7_s2", "raftstereo_tpu/ops/pallas_encoder.py:721",
        f"{dims(img)} (n_downsample=3)",
        lambda: ce.stem_conv7_s2(img, w1, b1),
        lambda: ce.conv_plain(img, w1, b1, 2), n2,
        2 * (img.numel() + w1.numel() + 64 + outs2) + 4 * 2 * 2 * 64,
        conv_cost(img, w1, outs2, n_in=0),
        lib=lambda: F.conv2d(img, w1h, b1h, 2, 3), reps=10,
        products=conv_products(w1, outs2))
    row("stem_conv7_s2", "", f"{dims(img1)} no sums (n_downsample=3)",
        lambda: ce.stem_conv7_s2(img1, w1, b1, want_stats=False),
        lambda: ce.conv_plain(img1, w1, b1, 2, want_stats=False), 1.0, None,
        0)
    # layer1 at the stride-2 stem's output size (n_downsample=3)
    xd = x[:, :, :h2, :w2].contiguous()
    row("stage_conv", "", f"{dims(xd)} (n_downsample=3)",
        lambda: ce.stage_conv(xd, a, wc, bc),
        lambda: ce.conv_plain(xd, wc, bc, 1, a), n2, None, 0)
    del xd
    # -- off the batch-1 path: row 10 at a batch-3 fnet
    path = "serve_fused_bf16"
    big = randn(6, 64, h, w).to(bf)
    row("plane_stats", "raftstereo_tpu/ops/pallas_norm.py:47 (via "
        "pallas_encoder.py:476)", f"{dims(big)} (batch 3)",
        lambda: ce.plane_stats(big), lambda: ce.stats_plain(big), n,
        2 * big.numel() + 4 * 2 * 6 * 64, 3 * big.numel(),
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


def train_fused_bf16_kernel_phase(model, torch):
    """The bf16 forms of the kernels that the bf16 fused training path
    (``train_fused_bf16``) launches, held against their bf16 plain
    versions and timed at its shapes: fnet's 12 images of 320x720 (cnet's
    6 images take the same kernels without sums: held), layer2 at
    160x360, the stats kernel on conv1's output, and the backward's dual
    sums (row 14's bf16 form) of two bf16 such tensors, held within
    DUAL_TOL; one row per kernel, beside one library call: cuDNN's
    ``F.conv2d`` on bf16 tensors, ``torch.var_mean``, and for the dual
    sums ``u.sum((2, 3), dtype=torch.float32)`` with a bf16 ``einsum``
    (cuBLAS, fp32 accumulation, a bf16 result: the closest single
    calls)."""
    import torch.nn.functional as F

    from raftstereo_tpu_torch.ops import cuda_encoder as ce

    dev = torch.device("cuda")
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(19)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    def aff(b, c):  # fp32; shifts > 0: padding before the prep would show
        return (0.5 + torch.rand((b, c), generator=g, device=dev),
                0.5 * torch.rand((b, c), generator=g, device=dev))

    def wb(m):
        return m.weight.detach(), m.bias.detach()

    def wb16(m):
        return m.weight.detach().to(bf), m.bias.detach().to(bf)

    rows = []
    path = "train_fused_bf16"

    def row(*args, **kw):
        enc_bf16_row(rows, path, *args, torch=torch, **kw)

    enc = model.fnet
    l0, _ = enc.layer1
    m0, _ = enc.layer2
    b, (h, w) = 2 * TRAIN_BATCH, TRAIN_HW
    h2, w2 = h // 2, w // 2
    n, n2 = float(h * w), float(h2 * w2)
    half = b // 2

    # -- row 14's bf16 form: fp32 sums of two bf16 tensors
    u, v = randn(b, 64, h, w), randn(b, 64, h, w)
    enc_row(rows, path, "dual_sums", "raftstereo_tpu/ops/pallas_encoder.py"
            ":1148", f"{dims(u)} bf16", lambda: ce.dual_sums(u, v),
            lambda: ce.dual_sums_plain(u, v), n, DUAL_TOL,
            2 * (u.numel() + v.numel()) + 4 * 2 * b * 64, 3 * u.numel(),
            torch, reps=10,
            lib=lambda: (u.sum((2, 3), dtype=torch.float32),
                         torch.einsum("bchw,bchw->bc", u, v)))
    del u, v
    # -- the stage: row 10 (conv1's sums), 9 (convs), 11 (finish)
    x = randn(b, 64, h, w)
    row("plane_stats", "raftstereo_tpu/ops/pallas_norm.py:47 (via "
        "pallas_encoder.py:476)", dims(x), lambda: ce.plane_stats(x),
        lambda: ce.stats_plain(x), n, 2 * x.numel() + 4 * 2 * b * 64,
        3 * x.numel(), reps=10,
        lib=lambda: torch.var_mean(x, dim=(2, 3), correction=0))
    a = aff(b, 64)
    wc, bc = wb(l0.conv1)
    wch, bch = wb16(l0.conv1)
    row("stage_conv", "raftstereo_tpu/ops/pallas_encoder.py:338, :348",
        dims(x), lambda: ce.stage_conv(x, a, wc, bc),
        lambda: ce.conv_plain(x, wc, bc, 1, a), n,
        2 * (2 * x.numel() + wc.numel() + 64) + 4 * 4 * b * 64,
        conv_cost(x, wc, x.numel(), n_in=1),
        lib=lambda: F.conv2d(x, wch, bch, 1, 1),
        products=conv_products(wc, x.numel()))
    r, c = randn(b, 64, h, w), randn(b, 64, h, w)
    a2, a3 = aff(b, 64), aff(b, 64)
    row("stage_conv", "", f"{dims(x)} res form",
        lambda: ce.stage_conv(x, a, wc, bc, res=r, res_aff=a2),
        lambda: ce.conv_plain(x, wc, bc, 1, a, r, a2), n, None, 0)
    x1 = x[:half].contiguous()
    a1 = (a[0][:half].contiguous(), a[1][:half].contiguous())
    row("stage_conv", "", f"{dims(x1)} no sums",
        lambda: ce.stage_conv(x1, a1, wc, bc, want_stats=False),
        lambda: ce.conv_plain(x1, wc, bc, 1, a1, want_stats=False), 1.0,
        None, 0)
    del x1
    row("stage_finish", "raftstereo_tpu/ops/pallas_encoder.py:364",
        dims(x), lambda: ce.stage_finish(x, a, r, a2, c, a3),
        lambda: ce.finish_plain(x, a, r, a2, c, a3), n,
        2 * 4 * x.numel() + 4 * 6 * b * 64, 12 * x.numel(), reps=10,
        exact=True)
    del r, c
    # -- layer2: entry (row 15), convs (row 16), finish (row 17)
    t = torch.relu(x)
    del x
    we, be = wb(m0.conv1)
    wp, bp = wb(m0.downsample[0])
    weh, beh = wb16(m0.conv1)
    out2 = b * 96 * h2 * w2
    row("l2_entry", "raftstereo_tpu/ops/pallas_layer2.py:118", dims(t),
        lambda: ce.l2_entry(t, we, be, wp, bp),
        lambda: ce.entry_plain(t, we, be, wp, bp), n2,
        2 * (t.numel() + we.numel() + wp.numel() + 2 * 96 + 2 * out2)
        + 4 * 2 * 2 * b * 96,
        conv_cost(t, we, out2, n_in=0, proj_flops=2 * out2 * 64) + 4 * out2,
        lib=lambda: F.conv2d(t, weh, beh, 2, 1),
        products=conv_products(we, out2, proj_flops=2 * out2 * 64))
    t1 = t[:half].contiguous()
    row("l2_entry", "", f"{dims(t1)} no sums",
        lambda: ce.l2_entry(t1, we, be, wp, bp, want_stats=False),
        lambda: ce.entry_plain(t1, we, be, wp, bp, want_stats=False), 1.0,
        None, 0)
    del t, t1
    y, p, q = (randn(b, 96, h2, w2) for _ in range(3))
    b_, pb, a4 = aff(b, 96), aff(b, 96), aff(b, 96)
    wl, bl = wb(m0.conv2)
    wlh, blh = wb16(m0.conv2)
    row("l2_conv", "raftstereo_tpu/ops/pallas_layer2.py:201, :212",
        dims(y), lambda: ce.l2_conv(y, b_, wl, bl),
        lambda: ce.conv_plain(y, wl, bl, 1, b_), n2,
        2 * (2 * y.numel() + wl.numel() + 96) + 4 * 4 * b * 96,
        conv_cost(y, wl, y.numel(), n_in=1),
        lib=lambda: F.conv2d(y, wlh, blh, 1, 1),
        products=conv_products(wl, y.numel()))
    row("l2_conv", "", f"{dims(y)} res_proj form",
        lambda: ce.l2_conv(y, b_, wl, bl, res=p, res_aff=pb),
        lambda: ce.conv_plain(y, wl, bl, 1, b_, p, pb, res_relu=False), n2,
        None, 0)
    y1 = y[:half].contiguous()
    b1 = (b_[0][:half].contiguous(), b_[1][:half].contiguous())
    row("l2_conv", "", f"{dims(y1)} no sums",
        lambda: ce.l2_conv(y1, b1, wl, bl, want_stats=False),
        lambda: ce.conv_plain(y1, wl, bl, 1, b1, want_stats=False), 1.0,
        None, 0)
    p1 = p[:half].contiguous()
    pb1 = (pb[0][:half].contiguous(), pb[1][:half].contiguous())
    row("l2_conv", "", f"{dims(y1)} res_proj form no sums",
        lambda: ce.l2_conv(y1, b1, wl, bl, res=p1, res_aff=pb1,
                           want_stats=False),
        lambda: ce.conv_plain(y1, wl, bl, 1, b1, p1, pb1, res_relu=False,
                              want_stats=False), 1.0, None, 0)
    del y1, p1
    row("l2_finish", "raftstereo_tpu/ops/pallas_layer2.py:228", dims(y),
        lambda: ce.l2_finish(p, pb, y, b_, q, a4),
        lambda: ce.finish_plain(p, pb, y, b_, q, a4, a_relu=False), n2,
        2 * 4 * y.numel() + 4 * 6 * b * 96, 12 * y.numel(), reps=10,
        exact=True)
    return rows


def same_bits(a, b, torch) -> bool:
    """Equal NaN positions and equal values elsewhere."""
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)))


def grid_samplers(vcat, widths, x, r, torch, grad=False):
    """One PyTorch call per level for the volume lookup: the upstream
    RAFT-Stereo ``bilinear_sampler``, ``F.grid_sample`` of the level's 1-D
    volume rows (B*H*W1, 1, 1, w) at the 2r+1 taps, align_corners, zero
    padding, in the volume's dtype (the grid too).  Returns per level
    (volume, grid), the volume a leaf that requires grad with ``grad``,
    and the calls."""
    import torch.nn.functional as F

    out, off = [], 0
    for lvl, w in enumerate(widths):
        v = vcat[..., off:off + w].reshape(-1, 1, 1, w).clone()
        taps = (x.reshape(-1, 1) / 2 ** lvl
                + torch.arange(-r, r + 1, device=x.device))
        gx = 2.0 * taps / max(w - 1, 1) - 1.0
        grid = torch.stack([gx, torch.zeros_like(gx)], -1)[:, None]
        out.append((v.requires_grad_(grad), grid.to(v.dtype)))
        off += w
    return out, [lambda v=v, gr=gr: F.grid_sample(v, gr, align_corners=True)
                 for v, gr in out]


def needed_columns(x, widths, r, torch) -> int:
    """(pixel, level, column) entries inside the level that the taps
    weight: columns floor(x_l) - r .. floor(x_l) + r + 1."""
    n = 0
    for lvl, w in enumerate(widths):
        b0 = torch.floor(x / 2 ** lvl) - r
        for d in range(2 * r + 2):
            j = b0 + d
            n += int(((j >= 0) & (j <= w - 1)).sum())
    return n


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
        return grid_samplers(vcat, widths, x, r, torch, grad)

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

        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        ok = int_bits(got, want, torch) and int_bits(got, again, torch)
        print(f"vol_lookup ({path}, vcat {dims(st.vcat)}): bitwise equal "
              f"to its plain version and repeatable: {ok}")
        check(ok, f"vol_lookup differs from its plain version ({path})")
        _, calls = sampler(st.vcat, st.widths, x)
        lib_out = torch.cat([f().reshape(got.shape[:3] + (k,))
                             for f in calls], -1)
        print(f"vol_lookup ({path}) library: {len(calls)} F.grid_sample "
              f"calls, one per level, max |diff| "
              f"{float((lib_out - got).abs().max()):.3e}")
        nout = got.numel()
        rows.append(timed(
            "vol_lookup", path, kern, plain,
            4 * (needed_columns(x, st.widths, r, torch) + x.numel() + nout),
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
    again = vol()
    torch.cuda.synchronize()
    check(same_bits(got, again, torch), "int8_volume is not bitwise "
                                        "repeatable")
    rows.append(timed("int8_volume", "serve_quant", vol, vol_plain,
                      q1.numel() + q2.numel()
                      + 4 * (s1.numel() + s2.numel() + got.numel()),
                      3 * got.numel(), lib=int_mm,
                      int8_ops=2 * got.numel() * c))
    vol_fwd_hostile_hold(torch)
    int8_hostile_hold(torch)
    return rows


def int_bits(a, b, torch) -> bool:
    """NaN at the same places, the same bits elsewhere (-0 apart from
    +0)."""
    ok = ~a.isnan()
    return (torch.equal(ok, ~b.isnan())
            and torch.equal(a[ok].view(torch.int32), b[ok].view(torch.int32)))


def vol_fwd_hostile_hold(torch) -> None:
    """Row 5 on coordinates whose rounded taps cross an integer (a window
    of K+2 columns, or a tap that repeats its neighbour's floor), NaN,
    +-inf, +-1e30, integers and half-integers, coordinates past both edges,
    a zero-width level, radius 0 and 8 levels (radius 8: the per-tap form),
    and a volume whose rows start at another 4-byte alignment: bitwise
    equal to plain and to a second call."""
    from raftstereo_tpu_torch.ops import cuda_vol

    g = torch.Generator().manual_seed(5)
    b, h, w1 = 2, 5, 64
    for widths, r, shift in (((64, 32, 16, 8), 4, 0), ((64, 32, 16, 8), 4, 1),
                             ((64, 32, 0, 8), 2, 0), ((64, 32), 0, 1),
                             ((64, 32, 16, 8, 4, 2, 1, 0), 8, 0),
                             ((64, 32, 16, 8, 4, 2, 1, 0), 3, 1)):
        w2 = sum(widths)
        x = torch.arange(w1) - 40.0 * torch.rand((b, h, w1), generator=g)
        x[0, 0, :14] = torch.tensor(
            [float("nan"), float("inf"), -float("inf"), 1e30, -1e30,
             127.99999, 0.99999994, 63.99999, 2.0 ** 24 + 2, -200.5,
             w1 + 300.25, r + 0.5, -r - 1.0000001, 31.999998])
        x[0, 1] = torch.arange(w1) * 0.5 - 8.0
        x[1, 2] = torch.arange(w1) - 0.0000019
        x = x.cuda().contiguous()
        base = torch.randn(b * h * w1 * w2 + 1, generator=g).cuda()
        vcat = base[shift:shift + b * h * w1 * w2].view(b, h, w1, w2)
        k1, k2 = (cuda_vol.vol_lookup(vcat, widths, x, r) for _ in "ab")
        want = cuda_vol.vol_lookup_plain(vcat, widths, x, r)
        torch.cuda.synchronize()
        ok = int_bits(k1, want, torch) and int_bits(k1, k2, torch)
        print(f"vol_lookup (hostile, widths {widths}, radius {r}, vcat "
              f"offset {shift}): bitwise equal to plain and repeatable: {ok}")
        check(ok, f"vol_lookup differs from its plain version on hostile "
                  f"inputs (widths {widths}, radius {r})")


def int8_hostile_hold(torch) -> None:
    """Row 7 on C = 16 and 48 (a k-step past C, zero-filled), C = 272 (two
    channel chunks), W2 = 9 and 130 and W1 = 241 (ragged tiles), rows of
    +127, -127 and -128 on every channel, random codes in [-128, 127] and
    zero scales: bitwise equal to plain (int32 views) and to a second
    call."""
    from raftstereo_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(7)
    for w1, w2, c in ((9, 9, 16), (130, 130, 48), (240, 9, 48),
                      (241, 130, 16), (48, 240, 272)):
        q1, q2 = (torch.randint(-128, 128, (1, 3, w, c), generator=g,
                                dtype=torch.int8) for w in (w1, w2))
        for q in (q1, q2):
            q[0, 0, 0], q[0, 0, 1], q[0, 0, -1] = 127, -127, -128
        s1, s2 = (0.001 + 0.1 * torch.rand((1, 3, w), generator=g)
                  for w in (w1, w2))
        s1[0, 1, w1 // 2] = 0.0
        s2[0, 2] = 0.0
        q1, q2, s1, s2 = (t.cuda() for t in (q1, q2, s1, s2))
        k1, k2 = (quant.int8_corr_volume(q1, s1, q2, s2) for _ in "ab")
        want = quant.int8_volume_plain(q1, s1, q2, s2)
        torch.cuda.synchronize()
        ok = int_bits(k1, want, torch) and int_bits(k1, k2, torch)
        print(f"int8_volume (hostile, W1 {w1}, W2 {w2}, C {c}, codes "
              f"-128..127, zero scales): bitwise equal to plain and "
              f"repeatable: {ok}")
        check(ok, f"int8_volume differs from its plain version on hostile "
                  f"inputs (W1 {w1}, W2 {w2}, C {c})")


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


def vol_bf16_kernel_phase(cfg, lo_hw, torch):
    """Rows 5 and 7's bf16 forms against their plain versions, bitwise,
    timed, one row per kernel and path: row 7 with a bf16 volume at the
    serving shape (path ``serve_turbo``), row 5 over the bf16 volume
    pyramid at the serving shape on the random and the smooth field
    (``serve_bf16_pallas``, ``serve_bf16_pallas_smooth``; the jump field
    held), over the int8 tier's bf16 pyramid (``serve_turbo``) and at the
    training op shape (``op_vol_bf16``); both also on hostile inputs.
    Returns the rows and the op path's launches."""
    from raftstereo_tpu_torch.ops import cuda_vol, quant
    from raftstereo_tpu_torch.ops.corr import build_corr_state, corr_lookup

    bf = torch.bfloat16
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(12)
    c, r, levels = 256, cfg.corr_radius, cfg.corr_levels

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    def coords(b, h, w):
        return (torch.arange(w, device=dev, dtype=torch.float32)
                - 60.0 * torch.rand((b, h, w), generator=g).to(dev)
                ).contiguous()

    def row(name, path, kern, plain, nbytes, flops, lib, int8_ops=0.0,
            reps=20):
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        ok = int_bits(got.float(), want.float(), torch) and int_bits(
            got.float(), again.float(), torch)
        print(f"{name} ({path}, {dims(got)} {got.dtype}): bitwise equal to "
              f"its plain version and repeatable: {ok}")
        check(ok, f"{name} ({path}) differs from its plain version")
        ms, plain_ms, lib_ms = (time_ms(kern, reps), time_ms(plain, 5),
                                time_ms(lib, 5))
        bound_ms, bound_by = bound(nbytes, flops, int8_ops)
        print(f"{name} ({path}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"library_ms {lib_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}, "
              f"{nbytes / 1e6:.2f} MB) [{CARD}]")
        src, replaces = VOLUME_SITES[name]
        return dict(name=name, path=path, route="cuda",
                    source=f"raftstereo_tpu_torch/csrc/{src}.cu",
                    replaces=replaces, dtype="bfloat16", max_abs_err=0.0,
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=lib_ms)

    rows = []
    # -- row 7 with a bf16 volume at the serving shape
    h, w = lo_hw
    q1, s1 = quant.quantize_rows(randn(1, h, w, c))
    q2, s2 = quant.quantize_rows(randn(1, h, w, c))
    fp32 = quant.int8_corr_volume(q1, s1, q2, s2)
    vol = quant.int8_corr_volume(q1, s1, q2, s2, out_dtype=bf)
    torch.cuda.synchronize()
    check(torch.equal(vol.view(torch.int16), fp32.to(bf).view(torch.int16)),
          "int8_volume's bf16 form is not its fp32 form rounded once")
    print(f"int8_volume bf16 sha256 {digest(vol.view(torch.int16))}, fp32 "
          f"sha256 {digest(fp32)}")
    rows.append(row(
        "int8_volume", "serve_turbo",
        lambda: quant.int8_corr_volume(q1, s1, q2, s2, out_dtype=bf),
        lambda: quant.int8_volume_plain(q1, s1, q2, s2, out_dtype=bf),
        q1.numel() + q2.numel() + 4 * (s1.numel() + s2.numel())
        + 2 * vol.numel(), 3 * vol.numel(),
        lambda: [torch._int_mm(q1[0, y], q2[0, y].t()) for y in range(h)],
        int8_ops=2 * vol.numel() * c))
    del fp32, vol

    # -- row 5 over bf16 pyramids
    def lookup_row(path, vcat, widths, x):
        _, calls = grid_samplers(vcat, widths, x, r, torch)
        nout = x.numel() * len(widths) * (2 * r + 1)
        return row("vol_lookup", path,
                   lambda: cuda_vol.vol_lookup(vcat, widths, x, r),
                   lambda: cuda_vol.vol_lookup_plain(vcat, widths, x, r),
                   2 * needed_columns(x, widths, r, torch)
                   + 4 * (x.numel() + nout), 8 * nout,
                   lambda: [f() for f in calls])

    st = build_corr_state(randn(1, h, w, c), randn(1, h, w, c), levels,
                          "pallas", corr_dtype=bf)
    check(st.vcat.dtype == bf, "the bf16 pallas state is not bf16")
    rows.append(lookup_row("serve_bf16_pallas", st.vcat, st.widths,
                           coords(1, h, w)))
    rows.append(lookup_row("serve_bf16_pallas_smooth", st.vcat, st.widths,
                           smooth_field(1, h, w, torch)))
    xj = jump_field(1, h, w, torch)
    ok = int_bits(cuda_vol.vol_lookup(st.vcat, st.widths, xj, r),
                  cuda_vol.vol_lookup_plain(st.vcat, st.widths, xj, r), torch)
    print(f"vol_lookup (jump field, bf16 volume): bitwise equal to plain: "
          f"{ok}")
    check(ok, "vol_lookup's bf16 form differs from plain on the jump field")
    qst = build_corr_state(randn(1, h, w, c), randn(1, h, w, c), levels,
                           "pallas", quant=True, corr_dtype=bf)
    rows.append(lookup_row("serve_turbo", qst.vcat, qst.widths,
                           coords(1, h, w)))
    del st, qst
    b, th, tw = (TRAIN_BATCH, TRAIN_HW[0] // cfg.factor,
                 TRAIN_HW[1] // cfg.factor)
    ost = build_corr_state(randn(b, th, tw, c), randn(b, th, tw, c), levels,
                           "pallas", corr_dtype=bf)
    xo = coords(b, th, tw)
    rows.append(lookup_row("op_vol_bf16", ost.vcat, ost.widths, xo))
    # the op path: one corr_lookup over the bf16 state, counted
    cuda_vol.vol_lookup.launches = 0
    feats = corr_lookup(ost, xo, r, bf)
    torch.cuda.synchronize()
    op_launches = {"vol_lookup": cuda_vol.vol_lookup.launches}
    check(op_launches == {"vol_lookup": 1} and feats.dtype == bf,
          f"corr_lookup over the bf16 state launched {op_launches}")
    del ost, feats
    torch.cuda.empty_cache()
    vol_bf16_hostile_hold(torch)
    return rows, {"op_vol_bf16": op_launches}


def vol_bf16_hostile_hold(torch) -> None:
    """Row 5 over bf16 volumes whose rows start at every 2-byte shift of
    a 16-byte chunk (the barrel shifter's every stage), on the hostile
    coordinates of ``vol_fwd_hostile_hold``; row 7's bf16 form at ragged
    W2 (9, 130: scalar stores) and W1 (241) with the full int8 range:
    bitwise equal to plain and to a second call."""
    from raftstereo_tpu_torch.ops import cuda_vol, quant

    g = torch.Generator().manual_seed(15)
    bf = torch.bfloat16
    b, h, w1 = 2, 5, 64
    for widths, r in (((64, 32, 16, 8), 4), ((64, 32, 0, 8), 2),
                      ((64, 32, 16, 8, 4, 2, 1, 0), 8)):
        w2 = sum(widths)
        x = torch.arange(w1) - 40.0 * torch.rand((b, h, w1), generator=g)
        x[0, 0, :14] = torch.tensor(
            [float("nan"), float("inf"), -float("inf"), 1e30, -1e30,
             127.99999, 0.99999994, 63.99999, 2.0 ** 24 + 2, -200.5,
             w1 + 300.25, r + 0.5, -r - 1.0000001, 31.999998])
        x[0, 1] = torch.arange(w1) * 0.5 - 8.0
        x = x.cuda().contiguous()
        base = torch.randn(b * h * w1 * w2 + 8, generator=g).cuda().to(bf)
        for shift in range(8):
            vcat = base[shift:shift + b * h * w1 * w2].view(b, h, w1, w2)
            k1, k2 = (cuda_vol.vol_lookup(vcat, widths, x, r) for _ in "ab")
            want = cuda_vol.vol_lookup_plain(vcat, widths, x, r)
            torch.cuda.synchronize()
            check(int_bits(k1, want, torch) and int_bits(k1, k2, torch),
                  f"vol_lookup's bf16 form differs from plain on hostile "
                  f"inputs (widths {widths}, radius {r}, shift {shift})")
    print("vol_lookup (hostile, bf16 volume at shifts 0..7): bitwise equal "
          "to plain and repeatable: True")
    for w1, w2, c in ((9, 9, 16), (130, 130, 48), (241, 130, 16),
                      (48, 240, 272)):
        q1, q2 = (torch.randint(-128, 128, (1, 3, w, c), generator=g,
                                dtype=torch.int8) for w in (w1, w2))
        s1, s2 = (0.001 + 0.1 * torch.rand((1, 3, w), generator=g)
                  for w in (w1, w2))
        q1, q2, s1, s2 = (t.cuda() for t in (q1, q2, s1, s2))
        k1, k2 = (quant.int8_corr_volume(q1, s1, q2, s2, out_dtype=bf)
                  for _ in "ab")
        want = quant.int8_volume_plain(q1, s1, q2, s2, out_dtype=bf)
        torch.cuda.synchronize()
        check(torch.equal(k1.view(torch.int16), want.view(torch.int16))
              and torch.equal(k1.view(torch.int16), k2.view(torch.int16)),
              f"int8_volume's bf16 form differs from plain (W1 {w1}, W2 "
              f"{w2}, C {c})")
    print("int8_volume (hostile, bf16 volume, ragged W1/W2, C 16..272): "
          "bitwise equal to plain and repeatable: True")


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
    epi_hold(state, jump_field(1, h, w, torch), r, ew, eb, "wide-span", torch)
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


def bwd_bf16_hold(name, path, kern, plain, torch):
    """A bf16 backward kernel against its plain version: both gradients
    bf16, within BWD_BF16_ULPS of max(1, |plain|) where plain is finite,
    at least BWD_BF16_EQUAL of those elements equal, NaN where plain has
    NaN; two calls bitwise equal.  Returns the largest absolute error and
    the outputs' digest."""
    k1, k2, want = kern(), kern(), plain()
    torch.cuda.synchronize()
    check(all(a.dtype == torch.bfloat16 for a in k1 + want),
          f"{name} ({path}): gradients not bf16")
    check(all(same_bits(a, b, torch) for a, b in zip(k1, k2)),
          f"{name} ({path}): two calls on the same inputs differ")
    err, equal, abs_err = 0.0, 1.0, 0.0
    for a, w in zip(k1, want):
        ok = torch.isfinite(w)
        check(torch.equal(a.isnan(), w.isnan()),
              f"{name} ({path}): NaN where plain has none, or none where "
              f"it has")
        err = max(err, ulps(a[ok], w[ok]))
        equal = min(equal, float((a[ok] == w[ok]).float().mean()))
        abs_err = max(abs_err, float((a[ok].float() - w[ok].float())
                                     .abs().max()))
    sha = digest(*k1)
    print(f"{name} ({path}) max {err:.3f} bf16 ulps, max_abs_err "
          f"{abs_err:.3e}, {equal:.5f} of elements equal (tol "
          f"{BWD_BF16_ULPS} ulps, {BWD_BF16_EQUAL} equal); bitwise "
          f"repeatable; sha {sha}")
    check(err <= BWD_BF16_ULPS and equal >= BWD_BF16_EQUAL,
          f"{name} ({path}) disagrees with its plain version: {err} bf16 "
          f"ulps, {equal} of elements equal")
    return abs_err, sha


def bf16_backward_phase(model, torch):
    """Row 4 radial's bf16 form (``alt_corr_backward`` on bf16 feature
    maps) at the training path's shapes (6x80x180, C=256, bf16 cotangent),
    on random and smooth disparities, with infinite cotangents held too:
    held against its plain version, timed, one row each (paths
    ``train_bf16``, ``train_bf16_smooth``)."""
    from raftstereo_tpu_torch.ops import cuda_alt
    from raftstereo_tpu_torch.ops.corr import build_corr_state

    cfg = model.config
    dev = torch.device("cuda")
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(7)
    bh, (th, tw) = TRAIN_BATCH, TRAIN_HW
    h, w = th // cfg.factor, tw // cfg.factor
    c, r = model.feature_dim, cfg.corr_radius
    k = 2 * r + 1

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    state = build_corr_state(randn(bh, h, w, c), randn(bh, h, w, c),
                             cfg.corr_levels, corr_dtype=bf)
    gout = randn(bh, h, w, cfg.cor_planes).to(bf)
    rows = []
    for path, x in (
            ("train_bf16", (torch.arange(w, device=dev, dtype=torch.float32)
                            - 60.0 * torch.rand((bh, h, w), generator=g)
                            .to(dev)).contiguous()),
            ("train_bf16_smooth", smooth_field(bh, h, w, torch))):
        def bwd(x=x):
            return cuda_alt.alt_corr_backward(state.fmap1, state.f2cat,
                                              state.widths, x, gout, r)

        def bwd_plain(x=x):
            return cuda_alt.alt_corr_backward_plain(
                state.fmap1, state.f2cat, state.widths, x, gout, r)

        abs_err, sha = bwd_bf16_hold("alt_corr_bwd", path, bwd, bwd_plain,
                                     torch)
        ms, plain_ms = time_ms(bwd, 20), time_ms(bwd_plain, 5)
        valid = 0  # (pixel, level, column) pairs inside the level
        for lvl, w2 in enumerate(state.widths):
            b0 = torch.floor(x / 2 ** lvl) - r
            for d in range(k + 1):
                j = b0 + d
                valid += int(((j >= 0) & (j <= w2 - 1)).sum())
        nbytes = (2 * (2 * state.fmap1.numel() + 2 * state.f2cat.numel()
                       + gout.numel()) + 4 * x.numel())
        flops = 4 * c * valid + 4 * (k + 1) * x.numel() * len(state.widths)
        bound_ms, bound_by = bound(nbytes, flops)
        print(f"alt_corr_bwd ({path}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {bound_ms:.4f} ({bound_by}, {nbytes / 1e6:.1f} MB)"
              f" [{CARD}]")
        rows.append(dict(name="alt_corr_bwd", path=path, route="cuda",
                         source="raftstereo_tpu_torch/csrc/alt_corr_bwd.cu",
                         replaces="raftstereo_tpu/ops/pallas_alt.py:195",
                         dtype="bfloat16", max_abs_err=abs_err, sha=sha,
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None))

    inf_cotangent_hold(state, x, gout, r, torch)
    return rows


def bf16_forward_card_vs_cpu(model, rng, torch):
    """A bf16 model's card forward (kernels) against the CPU's (plain
    versions) on a 64x96 pair, with the card's encoder outputs pinned in
    the CPU forward: the encoders' bf16 convs round about one output in
    10^4 to the other side on the card, instance norm spreads such a flip
    over its channel, and the random-weight GRU grows that noise as fast
    as bf16's own rounding.  Pinned, what is compared is the rest of the
    forward: the context convs, the bf16 correlation state, every
    iteration's kernels and the upsampling.  With ``corr_quant`` the
    card's int8 codes and scales are pinned too (``quant_forwards``'s
    reason).  The gap of the CPU's bf16 forward to its fp32 one (unpinned)
    is printed beside the tolerance, which must lie below it."""
    from raftstereo_tpu_torch import RAFTStereo
    from raftstereo_tpu_torch.ops import quant

    cfg = model.config
    cpu_model = copy.deepcopy(model).to("cpu")
    f32_model = RAFTStereo(dataclasses.replace(
        cfg, compute_dtype="float32", corr_dtype="float32"), device="cpu")
    f32_model.load_state_dict(cpu_model.state_dict())
    i1, i2 = (torch.from_numpy(rng.uniform(0, 255, (1, 64, 96, 3))
                               .astype(np.float32)) for _ in range(2))
    seen, codes, real = {}, [], quant.quantize_rows
    cnet, fnet = model.cnet.forward, model.fnet.forward
    model.cnet.forward = lambda x: seen.setdefault("cnet", cnet(x))
    model.fnet.forward = lambda x: seen.setdefault("fnet", fnet(x))
    quant.quantize_rows = lambda x: codes.append(real(x)) or codes[-1]
    try:
        lo_g, up_g = model(i1.cuda(), i2.cuda(), iters=BF16_ITERS)
    finally:
        del model.cnet.forward, model.fnet.forward
        quant.quantize_rows = real
    if cfg.fused_encoder:
        fused_trunks_card_vs_cpu(model, cpu_model, i1, i2, torch)
        fused_encoders_card_vs_cpu(cpu_model, seen, i1, i2, torch)
    cpu_model.cnet.forward = lambda x: [[t.cpu() for t in lvl]
                                        for lvl in seen["cnet"]]
    cpu_model.fnet.forward = lambda x: seen["fnet"].cpu()
    pinned = iter([tuple(t.cpu() for t in c) for c in codes])
    quant.quantize_rows = lambda x: next(pinned)
    try:
        lo_c, up_c = cpu_model(i1, i2, iters=BF16_ITERS)
    finally:
        quant.quantize_rows = real
    check(len(codes) == 2 * cfg.corr_quant, f"{len(codes)} quantized maps")
    lo_f, up_f = f32_model(i1, i2, iters=BF16_ITERS)
    tag = (f"bf16 {cfg.corr_dtype} {cfg.corr_implementation} corr"
           f"{' corr_quant' * cfg.corr_quant}, {cfg.gru_backend} GRU ")
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


def _norm_bf16(img, torch):
    """The model's image normalisation, in bf16 and NCHW."""
    return (2.0 * (img.float() / 255.0) - 1.0).to(torch.bfloat16).permute(
        0, 3, 1, 2)


def fused_trunk_readings(model, cpu_model, i1, i2, torch):
    """The bf16 fused trunks (stem + layer1 + layer2: what the encoder
    kernels compute) of fnet (both images) and cnet (the left one): the
    card's (kernels) against the CPU's (plain versions) in max bf16 ulps
    of max(1, |cpu|) and share of elements equal, beside the CPU's
    plain-encoder trunk (``fused_stem=False``: the plain bf16 convolutions
    and norms) against the same CPU fused trunk.  Returns
    {encoder: (card ulps, card equal share, plain ulps, plain equal
    share)}."""
    from raftstereo_tpu_torch.models import encoders

    def trunk(enc, x):
        return encoders._trunk_layer2(enc, encoders._stem_layer1(enc, x))

    a, b = _norm_bf16(i1, torch), _norm_bf16(i2, torch)
    out = {}
    for name, x in (("fnet", torch.cat([a, b]).contiguous()),
                    ("cnet", a.contiguous())):
        card_enc, cpu_enc = getattr(model, name), getattr(cpu_model, name)
        with torch.inference_mode():
            card = trunk(card_enc, x.cuda()).cpu()
            cpu = trunk(cpu_enc, x)
            fused, cpu_enc.fused_stem = cpu_enc.fused_stem, False
            try:
                plain = trunk(cpu_enc, x)
            finally:
                cpu_enc.fused_stem = fused
        out[name] = (ulps(card, cpu), float((card == cpu).float().mean()),
                     ulps(plain, cpu), float((plain == cpu).float().mean()))
    return out


def fused_trunks_card_vs_cpu(model, cpu_model, i1, i2, torch):
    """The card's bf16 fused trunks against the CPU's within their
    FUSED_TRUNK_TOL ulps and equal share; for fnet both limits must also
    lie closer than the CPU's plain bf16 encoders' reading in this run
    (``fused_trunk_readings``), so that the hold tells the fused stages
    from the plain encoders."""
    for name, (u, eq, pu, peq) in fused_trunk_readings(
            model, cpu_model, i1, i2, torch).items():
        lim, floor, apart = FUSED_TRUNK_TOL[name]
        print(f"fused bf16 trunk {name} card vs cpu: max {u:.3f} bf16 ulps, "
              f"{eq:.4f} of elements equal (tol {lim} ulps, {floor} equal"
              f"{', below the plain reading' if apart else ''}); cpu "
              f"plain-encoder trunk vs fused: max {pu:.3f} ulps, {peq:.4f} "
              f"equal")
        ok = u <= lim and eq >= floor
        check(ok and (not apart or (lim < pu and floor > peq)),
              f"fused bf16 trunk {name}: card vs cpu {u} ulps, {eq} equal; "
              f"plain vs fused {pu} ulps, {peq} equal; limits {lim} ulps, "
              f"{floor} equal")


def fused_encoders_card_vs_cpu(cpu_model, seen, i1, i2, torch):
    """The bf16 fused encoders' outputs of a card forward (kernels) against
    the CPU's (plain versions) on the same normalised images: fnet's
    feature maps (``fmap``) and cnet's hidden and context heads per level
    (``net``, ``inp``), each within FUSED_ENC_CARD_ULPS of max(1, |cpu|).
    The card's conv sums round an output to the other bf16 neighbour now
    and then (its fp32 sums in another order), and the stages after it
    spread the flip (a conv to its neighbours, an instance norm's sums to
    its channel), as between the port and JAX on the CPU
    (tests/test_torch_port_enc_bf16.py)."""
    bf = torch.bfloat16
    a, b = _norm_bf16(i1, torch), _norm_bf16(i2, torch)
    with torch.inference_mode():
        fmap = cpu_model.fnet(torch.cat([a, b]).contiguous())
        ctx = cpu_model.cnet(a.contiguous())
    outs = [("fmap", seen["fnet"], fmap)] + [
        (f"{('net', 'inp')[k]}{lvl}", seen["cnet"][lvl][k], ctx[lvl][k])
        for lvl in range(len(ctx)) for k in range(2)]
    for name, g, c in outs:
        g = g.cpu()
        u, eq = ulps(g, c), float((g == c).float().mean())
        print(f"fused bf16 encoder {name} {dims(g)} card vs cpu: max {u:.3f}"
              f" bf16 ulps, {eq:.4f} of elements equal (tol "
              f"{FUSED_ENC_CARD_ULPS})")
        check(g.dtype == bf and u <= FUSED_ENC_CARD_ULPS,
              f"fused bf16 encoder {name}: card vs cpu {u} ulps")


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


def serve_tiers_phase(model, scfg, pairs, torch):
    """The accuracy tiers through the port's entry points on the card:
    ``cli.certify`` measures the ``fast`` and ``turbo`` EPE deltas of the
    flagship (random weights, so with the explicit ``TIER_BOUNDS``), then
    a server built with ``--tiers certified fast turbo`` and that manifest
    serves each request with no ``accuracy`` and with each tier.  Each
    reply is bitwise a direct engine call in its mode; no ``accuracy`` and
    ``certified`` give the fp32 base's bits; each request launches its
    tier's kernels (``TIER_PER_REQUEST``).  An unknown tier is a 400, and
    so is ``turbo`` under a second manifest that holds it over its bound.
    Returns the launches per tier over its requests."""
    from raftstereo_tpu_torch.cli import certify as cli_certify
    from raftstereo_tpu_torch.serve.server import build_server, decode_array

    cfg = model.config
    flags = ["--device", "cuda", "--corr_implementation",
             cfg.corr_implementation, "--gru_backend", cfg.gru_backend,
             "--cert_height", str(TIER_CERT[0][0]), "--cert_width",
             str(TIER_CERT[0][1]), "--cert_pairs", str(TIER_CERT[1]),
             "--cert_iters", str(TIER_CERT[2])]
    flags += ["--fused_encoder"] * bool(cfg.fused_encoder)
    tag = "fused " * bool(cfg.fused_encoder)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        path, over = os.path.join(tmp, "cert.json"), os.path.join(
            tmp, "over.json")
        t0 = time.perf_counter()
        rc = cli_certify.main(flags + ["--out", path, "--tiers", "fast",
                                       "turbo", "--bound"] + [
            f"{t}={b}" for t, b in TIER_BOUNDS.items()])
        with open(path) as f:
            manifest = json.load(f)
        deltas = {t: e["epe_delta"] for t, e in manifest["tiers"].items()}
        print(f"certify: rc {rc} in {time.perf_counter() - t0:.1f}s, "
              f"platform {manifest['platform']}, epe_ref "
              f"{manifest['eval']['epe_ref']}, epe deltas {deltas} (bounds "
              f"{TIER_BOUNDS}) [{CARD}]")
        check(rc == 0 and all(e["certified"]
                              for e in manifest["tiers"].values()),
              f"certify refused a tier: {manifest['tiers']}")
        check(manifest["platform"]["device"] == "cuda",
              f"manifest platform {manifest['platform']}")
        rc = cli_certify.main(flags + ["--out", over, "--tiers", "turbo",
                                       "--bound",
                                       f"turbo={deltas['turbo'] - 1.0}"])
        check(rc == 1, f"certify over its bound exited {rc}")
        tiers = ("certified", "fast", "turbo")
        t0 = time.perf_counter()
        server = build_server(model, dataclasses.replace(
            scfg, tiers=tiers, cert_manifest=path), device="cuda")
        print(f"tier server warm in {time.perf_counter() - t0:.1f}s: "
              f"advertised {server.tiers}, refused {server.tier_reasons}")
        check(server.tiers == {"certified": "fp32", "fast": "bf16",
                               "turbo": "int8"}, f"tiers {server.tiers}")
        for mode in ("bf16", "int8"):  # a fused base's tiers stay fused
            tcfg = server.engine.model_for(mode).config
            check(tcfg.compute_dtype == "bfloat16"
                  and tcfg.fused_encoder == cfg.fused_encoder,
                  f"{tag}tier model {mode}: {tcfg}")
        refusing = build_server(model, dataclasses.replace(
            scfg, tiers=("certified", "turbo"), cert_manifest=over),
            device="cuda", warmup=False)
        server.start()
        refusing.start()
        counted = serving_wrappers()
        try:
            for accuracy in (None,) + tiers:
                lat, got = [], {}
                for left, right in pairs:
                    for fn in counted:
                        fn.launches = 0
                    status, rep = post_tier(server.port, left, right,
                                            accuracy)
                    for fn in counted:
                        if fn.launches:
                            got[fn.__name__] = (got.get(fn.__name__, 0)
                                                + fn.launches)
                    check(status == 200, f"{accuracy}: {status} {rep}")
                    check(rep["meta"].get("accuracy") == accuracy,
                          f"meta {rep['meta']}")
                    lat.append(rep["meta"]["latency_ms"])
                    disp = decode_array(rep["disparity"])
                    (direct,) = server.engine.infer_batch(
                        [(left, right)], ITERS,
                        mode=server.mode_of(accuracy))
                    check(disp.shape == IMAGE_HW
                          and bool(np.isfinite(disp).all()),
                          f"{accuracy}: reply {disp.shape}")
                    check(np.array_equal(disp, direct),
                          f"{accuracy}: reply differs from a direct engine "
                          f"call in its mode")
                    if accuracy in (None, "certified"):
                        (base,) = server.engine.infer_batch(
                            [(left, right)], ITERS)
                        check(np.array_equal(disp, base),
                              f"{accuracy}: not the base model's bits")
                launches[accuracy or "default"] = got
                print(f"{tag}tier {accuracy or '(none)'}: meta.latency_ms "
                      f"{[round(v, 3) for v in lat]} launches "
                      f"{launches[accuracy or 'default']} [{CARD}]")
            left, right = pairs[0]
            status, rep = post_tier(server.port, left, right, "ultra")
            check(status == 400 and "unknown accuracy tier" in rep["error"],
                  f"unknown tier: {status} {rep}")
            status, rep = post_tier(refusing.port, left, right, "turbo")
            print(f"turbo under the over-bound manifest: {status} "
                  f"{rep['error']}")
            check(status == 400 and "over bound" in rep["error"],
                  f"over-bound tier: {status} {rep}")
        finally:
            for srv in (server, refusing):
                srv.shutdown()
                srv.server_close()
    # a fused base's every tier runs the encoder kernels too (in its
    # compute dtype: fp32 for certified, bf16 for fast and turbo)
    enc = FUSED_PER_REQUEST if cfg.fused_encoder else {}
    for tier, per_request in TIER_PER_REQUEST.items():
        want = {k: v * len(pairs) for k, v in dict(per_request, **enc).items()
                if v}
        check(launches[tier] == want, f"tier {tier}: launches "
                                      f"{launches[tier]}, want {want}")
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
                  f"{' fused encoder' * bool(mcfg.fused_encoder)}"
                  f"{' bf16' * (mcfg.compute_dtype == 'bfloat16')} to step "
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


def pinned_step(model, pinned, batch, dev, torch, dtype=None):
    """One train-mode forward and backward of ``model`` on ``dev`` (3
    iterations, ``sequence_loss``) with its encoders' outputs pinned to
    ``pinned`` (cnet's heads per level, fnet's maps, as leaf tensors in
    ``dtype``, default as given): the encoders still run, each output
    takes its pinned value, and its cotangent reaches both the leaf and
    the encoder, whose backward runs on it.  Returns the loss, the
    predictions, every parameter's gradient and the leaves' cotangents,
    on the CPU."""
    from raftstereo_tpu_torch.train.loss import sequence_loss

    class Pin(torch.autograd.Function):
        @staticmethod
        def forward(ctx, out, value):
            return value.detach().clone()

        @staticmethod
        def backward(ctx, g):
            return g, g

    def leaf(t):
        return t.detach().to(dev, dtype or t.dtype).clone().requires_grad_()

    couts = [[leaf(t) for t in lvl] for lvl in pinned[0]]
    fmaps = leaf(pinned[1])
    cnet, fnet = model.cnet.forward, model.fnet.forward
    model.cnet.forward = lambda x: [[Pin.apply(o, p) for o, p in zip(lo, lp)]
                                    for lo, lp in zip(cnet(x), couts)]
    model.fnet.forward = lambda x: Pin.apply(fnet(x), fmaps)
    try:
        preds = model(*(t.to(dev) for t in batch[:2]), iters=3,
                      test_mode=False)
        loss, _ = sequence_loss(preds, *(t.to(dev) for t in batch[2:]))
        loss.backward()
    finally:
        del model.cnet.forward, model.fnet.forward
    grads = {k: p.grad.detach().float().cpu()
             for k, p in model.named_parameters()}
    cots = [t.grad.detach().float().cpu() for lvl in couts for t in lvl]
    return (float(loss.detach()), preds.detach().float().cpu(), grads,
            cots + [fmaps.grad.float().cpu()])


def bf16_train_step_card_vs_cpu(torch, batch, corr_dtype, **kw):
    """One bf16 train step (``pallas_alt`` unless ``kw`` says otherwise,
    flagship widths, 3 iterations, the 64x96 batch) on the card (the
    lookup and its backward as kernels, cuDNN's bf16 convs) against the
    CPU (plain versions, oneDNN's), with the card's bf16 encoder outputs
    pinned in both (``pinned_step``: the encoders run under their pinned
    outputs, their gradients flowing through them; with
    ``fused_encoder=True`` through the fused stages' bf16 backward, row
    14's bf16 form among it): the loss (within BF16_STEP_LOSS_TOL,
    relative), and the predictions, every parameter's gradient, and the
    cotangents reaching fnet's maps and cnet's outputs, each as a 2-norm
    distance card-CPU at most BF16_STEP_SHARE of the CPU's own
    bf16-vs-fp32 distance on the same pinned inputs, so a card step that
    ran fp32 fails.  The encoders' gradients' share alone is printed
    beside."""
    from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig

    cfg = RAFTStereoConfig(**dict(dict(
        corr_implementation="pallas_alt", compute_dtype="bfloat16",
        corr_dtype=corr_dtype), **kw))
    model = RAFTStereo(cfg, device="cuda", seed=1)
    cpu_model = copy.deepcopy(model).to("cpu")
    f32_model = RAFTStereo(dataclasses.replace(
        cfg, compute_dtype="float32", corr_dtype="float32"), device="cpu")
    f32_model.load_state_dict(cpu_model.state_dict())
    seen = {}
    cnet, fnet = model.cnet.forward, model.fnet.forward
    model.cnet.forward = lambda x: seen.setdefault("cnet", cnet(x))
    model.fnet.forward = lambda x: seen.setdefault("fnet", fnet(x))
    try:
        with torch.no_grad():
            model(*(t.cuda() for t in batch[:2]), iters=1, test_mode=False)
    finally:
        del model.cnet.forward, model.fnet.forward
    pinned = (seen["cnet"], seen["fnet"])
    got = pinned_step(model, pinned, batch, "cuda", torch)
    want = pinned_step(cpu_model, pinned, batch, "cpu", torch)
    f32 = pinned_step(f32_model, pinned, batch, "cpu", torch, torch.float32)
    label = (f"{cfg.corr_implementation}, {corr_dtype} corr"
             f"{', fused encoder' * bool(cfg.fused_encoder)}")
    check(np.isfinite(got[0]) and all(bool(torch.isfinite(g).all())
                                      for g in got[2].values()),
          f"bf16 train step ({label}): non-finite loss or gradient")

    def flat(d):
        return torch.cat([t.reshape(-1) for t in
                          (d.values() if isinstance(d, dict) else d)])

    def share(i, keep=lambda k: True):
        a, b, c = (flat({k: t for k, t in d[i].items() if keep(k)})
                   if isinstance(d[i], dict) else flat(d[i])
                   for d in (got, want, f32))
        return float((a - b).norm() / (c - b).norm())

    loss_err = abs(got[0] - want[0]) / abs(want[0])
    shares = {name: share(i) for i, name in
              ((1, "predictions"), (2, "gradients"), (3, "cotangents"))}
    enc = share(2, lambda k: k.startswith(("cnet.", "fnet.")))
    print(f"bf16 train step ({label}) card vs cpu (encoder outputs "
          f"pinned): loss {got[0]:.6g} vs {want[0]:.6g} (fp32 {f32[0]:.6g};"
          f" relative error {loss_err:.2e}, tol {BF16_STEP_LOSS_TOL}); "
          f"distance over the cpu's bf16-vs-fp32 distance: "
          + ", ".join(f"{k} {v:.3f}" for k, v in shares.items())
          + f" (tol {BF16_STEP_SHARE}); the encoders' gradients alone "
          f"{enc:.3f}")
    check(loss_err <= BF16_STEP_LOSS_TOL
          and all(v <= BF16_STEP_SHARE for v in shares.values()),
          f"card bf16 train step ({label}) differs from the CPU's: loss "
          f"{loss_err}, {shares}")


def counted_wrappers():
    """Every counted kernel wrapper of the port."""
    from raftstereo_tpu_torch.ops import alt_lookup, norm

    return training_wrappers() + (alt_lookup.alt_corr_taps,
                                  alt_lookup.alt_corr_taps_backward,
                                  norm.in_norm_cluster, norm.in_stats,
                                  norm.in_apply)


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


def op_taps_smooth(b, h, w1, widths, k, g, torch):
    """``op_taps`` with coherent centres: per level the centre follows a
    slowly varying disparity along each row (a sine of x and y in [0, 60]
    at level 0, scaled to the level), taps 0-4 the radial pattern around
    it, taps 5-8 within 4 of it (7 an integer); the same far tap and NaN
    tap."""
    xx = torch.arange(w1, dtype=torch.float32)
    yy = (torch.arange(b * h) % h).float().reshape(-1, 1)
    disp = 30.0 + 30.0 * torch.sin(2 * np.pi * (xx / 97.0 + yy / 13.0))
    cols = []
    for w in widths:
        centre = ((xx - disp) * (w / w1))[..., None]   # (B*H, W1, 1)
        t = centre + torch.rand((b * h, w1, k), generator=g) * 8 - 4
        t[..., :5] = centre + torch.arange(-2.0, 3.0)
        t[..., 7] = torch.floor(t[..., 7])
        cols.append(t)
    taps = torch.cat(cols, dim=-1)
    taps[0, 0, k - 1] = 1e6
    taps[-1, -1, 2] = float("nan")
    return taps.cuda().contiguous()


def digest(*ts) -> str:
    """SHA-256 (first 16 hex digits) of tensors' bytes: equal digests from
    two trees mean bitwise equal outputs."""
    import torch

    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()[:16]


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
    training recipe (12x64x160x360) in fp32 and bf16, both forms.
    Returns the rows and the op path's inputs by path (``lookup``,
    ``x``)."""
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
                                   ("op_serve_bf16", bf, bf),
                                   ("op_train_bf16", bf, bf)):
        b, h, w = shapes[path.replace("_bf16", "")]
        st = build_corr_state(randn(b, h, w, c), randn(b, h, w, c), levels,
                              corr_dtype=dtype)
        f1 = st.fmap1.reshape(b * h, w, c)
        f2 = st.f2cat.reshape(b * h, -1, c)
        taps = op_taps(b, h, w, st.widths, k, g, torch)
        odt = out_dtype or torch.float32
        inputs[path] = {"lookup": (f1, f2, taps, st.widths, (b, h, w))}

        def kern():
            return al.alt_corr_taps(f1, f2, taps, st.widths, odt)

        def plain():
            return al.alt_corr_taps_plain(f1, f2, taps, st.widths, odt)

        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        check(got.dtype == odt and int(got.isnan().sum()) == 1,
              f"alt_corr_taps ({path}): dtype {got.dtype}, "
              f"{int(got.isnan().sum())} NaN entries (want 1)")
        check(same_bits(got.float(), again.float(), torch),
              f"alt_corr_taps ({path}): two calls on the same inputs differ")
        err = rel_err(got, want, torch)
        tol = BF16_ULP * LOOKUP_BF16_ULPS if odt == bf else TAPS_TOL
        abs_err = float((got.float() - want.float()).nan_to_num().abs().max())
        print(f"alt_corr_taps ({path}, {dims(f1)} x {dims(f2)}, taps "
              f"{dims(taps)}) max_abs_err {abs_err:.3e}, max rel {err:.3e} "
              f"(tol {tol}); bitwise repeatable; sha {digest(got)}")
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
        if path in ("op_serve", "op_train"):
            smooth_taps_hold(path, f1, f2, st.widths, (b, h, w), k, g, torch)
        if path == "op_serve":
            general_taps_hold(g, torch)
        if path == "op_train_bf16":
            rows += taps_bwd_bf16_rows(f1, f2, taps, st.widths, (b, h, w), k,
                                       g, torch)
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
              f"repeatable; sha {digest(*k1)}")
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
                               ("op_serve_bf16", (2, 64, 288, 480), bf),
                               ("op_train_bf16", (12, 64, 160, 360), bf)):
        x = (randn(*shape) * 1.5 + 0.4).to(dtype)
        inputs.setdefault(path, {})["x"] = x
        cs, vals = norm.cluster_plan(shape[2] * shape[3], dtype)
        esize = 2 if dtype == bf else 4
        for relu in (True, False):
            def kern(relu=relu):
                return norm.instance_norm_act(x, relu)

            def two(relu=relu):  # the two-kernel form, forced
                return norm.in_apply(x, *norm.in_stats(x), relu)

            def plain(relu=relu):
                return norm.in_apply_plain(x, *norm.in_stats_plain(x), relu)

            k1, k2, t1, want = kern(), kern(), two(), plain()
            torch.cuda.synchronize()
            check(torch.equal(k1, k2), "instance_norm: two calls differ")
            err, err2 = rel_err(k1, want, torch), rel_err(t1, want, torch)
            tol = BF16_ULP if dtype == bf else INORM_TOL
            abs_err = float((k1.float() - want.float()).abs().max())
            print(f"instance_norm ({path}, {dims(x)} {x.dtype}, relu {relu}, "
                  f"cluster of {cs} x {vals * esize} B) max_abs_err "
                  f"{abs_err:.3e}, max rel {err:.3e}, stats + apply "
                  f"{err2:.3e} (tol {tol}); bitwise repeatable")
            check(err <= tol and err2 <= tol,
                  f"instance_norm disagrees with its plain version by "
                  f"{err} (cluster), {err2} (two kernels) ({path}, relu "
                  f"{relu})")
        mean, rstd = norm.in_stats(x)
        ms, plain_ms = time_ms(kern, 20), time_ms(plain, 5)
        ms_two = time_ms(two, 20)
        ms_stats = time_ms(lambda: norm.in_stats(x), 20)
        ms_apply = time_ms(lambda: norm.in_apply(x, mean, rstd), 20)
        lib_ms = time_ms(lambda: F.instance_norm(x, eps=1e-5), 20)
        cold = {}
        if x.numel() * esize < L2_BYTES:  # back-to-back calls find x in L2
            cold = dict(ms_l2_cold=time_cold_ms(kern),
                        ms_two_kernel_l2_cold=time_cold_ms(two),
                        library_ms_l2_cold=time_cold_ms(
                            lambda: F.instance_norm(x, eps=1e-5)))
        bound_ms, bound_by = bound(2 * esize * x.numel(), 5 * x.numel())
        print(f"instance_norm ({path}) ms {ms:.4f} (cluster; stats + apply "
              f"{ms_two:.4f}: stats {ms_stats:.4f}, apply {ms_apply:.4f}) "
              f"plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
              f"(F.instance_norm) bound_ms {bound_ms:.4f} ({bound_by}) "
              + "".join(f"{k} {v:.4f} " for k, v in cold.items())
              + f"[{CARD}]")
        rows.append(dict(name="instance_norm", path=path, shape=dims(x),
                         route="cuda",
                         source="raftstereo_tpu_torch/csrc/inorm.cu",
                         replaces="raftstereo_tpu/ops/pallas_norm.py:47, :66",
                         max_abs_err=abs_err, ms=ms, ms_two_kernel=ms_two,
                         ms_stats=ms_stats, ms_apply=ms_apply,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms, **cold))
    return rows, inputs


def smooth_taps_hold(path, f1, f2, widths, bhw, k, g, torch):
    """Rows 3 and (at op_train) 4 general on ``op_taps_smooth``'s coherent
    taps, with no row: held against their plain versions (TAPS_TOL; row 4
    BACKWARD_TOL, bitwise repeatable, its NaN tap poisoning), two calls of
    row 3 bitwise equal, timed, digests printed."""
    from raftstereo_tpu_torch.ops import alt_lookup as al

    taps = op_taps_smooth(*bhw, widths, k, g, torch)

    def kern():
        return al.alt_corr_taps(f1, f2, taps, widths)

    got, again = kern(), kern()
    want = al.alt_corr_taps_plain(f1, f2, taps, widths)
    torch.cuda.synchronize()
    err = rel_err(got, want, torch)
    check(int(got.isnan().sum()) == 1 and same_bits(got, again, torch),
          f"alt_corr_taps ({path}, smooth taps): {int(got.isnan().sum())} "
          f"NaN entries (want 1), or two calls differ")
    check(err <= TAPS_TOL, f"alt_corr_taps disagrees with its plain version "
                           f"by {err} ({path}, smooth taps)")
    ms = time_ms(kern, 50)
    print(f"alt_corr_taps ({path}, smooth taps) max rel {err:.3e} (tol "
          f"{TAPS_TOL}); bitwise repeatable; sha {digest(got)} ms {ms:.4f} "
          f"[{CARD}]")
    if path != "op_train":
        return
    gout = torch.randn(taps.shape, generator=g).cuda()

    def bwd():
        return al.alt_corr_taps_backward(f1, f2, taps, gout, widths)

    k1, k2 = bwd(), bwd()
    want = al.alt_corr_taps_backward_plain(f1, f2, taps, gout, widths)
    torch.cuda.synchronize()
    check(all(same_bits(a, b_, torch) for a, b_ in zip(k1, k2)),
          "alt_corr_taps_bwd (smooth taps): two calls differ")
    check(all(int(a.isnan().sum()) > 0 for a in k1),
          "alt_corr_taps_bwd (smooth taps): the NaN tap poisoned nothing")
    scale = max(1.0, *(float(p[torch.isfinite(p)].abs().max())
                       for p in want))
    err = max(rel_err(a / scale, p / scale, torch) for a, p in zip(k1, want))
    check(err <= BACKWARD_TOL, f"alt_corr_taps_bwd disagrees with its plain "
                               f"version by {err} (smooth taps)")
    ms = time_ms(bwd, 20)
    print(f"alt_corr_taps_bwd ({path}, smooth taps) {err:.3e} of the largest "
          f"(tol {BACKWARD_TOL}); bitwise repeatable; sha {digest(*k1)} ms "
          f"{ms:.4f} [{CARD}]")


def taps_bwd_bf16_rows(f1, f2, taps, widths, bhw, k, g, torch):
    """Row 4 general's bf16 form (``alt_corr_taps_backward`` on bf16
    feature maps, a bf16 cotangent) at the op-train shape (480 rows of
    180 pixels, C=256, 36 taps: ``op_taps``, whose radial taps hit a
    column with two taps, and the smooth ``op_taps_smooth``): held against
    its plain version, timed, one row each (paths ``op_train_bf16``,
    ``op_train_bf16_smooth``)."""
    from raftstereo_tpu_torch.ops import alt_lookup as al

    rows = []
    c = f1.shape[-1]
    for path, tp in (("op_train_bf16", taps),
                     ("op_train_bf16_smooth",
                      op_taps_smooth(*bhw, widths, k, g, torch))):
        gout = torch.randn(tp.shape, generator=g).cuda().to(torch.bfloat16)

        def bwd(tp=tp, gout=gout):
            return al.alt_corr_taps_backward(f1, f2, tp, gout, widths)

        def bwd_plain(tp=tp, gout=gout):
            return al.alt_corr_taps_backward_plain(f1, f2, tp, gout, widths)

        abs_err, sha = bwd_bf16_hold("alt_corr_taps_bwd", path, bwd,
                                     bwd_plain, torch)
        check(all(int(a.isnan().sum()) > 0 for a in bwd()),
              f"alt_corr_taps_bwd ({path}): the NaN tap poisoned nothing")
        ms, plain_ms = time_ms(bwd, 20), time_ms(bwd_plain, 5)
        nbytes = (2 * (2 * f1.numel() + 2 * f2.numel() + gout.numel())
                  + 4 * tp.numel())
        flops = 4 * c * taps_columns(tp, widths, k, torch) + 6 * tp.numel()
        bound_ms, bound_by = bound(nbytes, flops)
        print(f"alt_corr_taps_bwd ({path}) ms {ms:.4f} plain_ms "
              f"{plain_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}, "
              f"{nbytes / 1e6:.1f} MB) [{CARD}]")
        rows.append(dict(name="alt_corr_taps_bwd", path=path, route="cuda",
                         source="raftstereo_tpu_torch/csrc/"
                                "alt_corr_taps_bwd.cu",
                         replaces="raftstereo_tpu/ops/pallas_alt.py:195",
                         dtype="bfloat16", max_abs_err=abs_err, sha=sha,
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None))
    return rows


def general_taps_hold(g, torch):
    """Row 3's general form, which the lookup takes where a tile's dots
    outgrow shared memory: 16 rows of 240 pixels, one 700-wide level and
    400 taps a pixel in ``op_taps``' pattern, C=256, with no row.  Checks
    that the tiled form is not taken there, holds the kernel against its
    plain version (TAPS_TOL, one NaN at the NaN tap), two calls bitwise
    equal, and times both."""
    from raftstereo_tpu_torch.ops import alt_lookup as al

    rows, w1, widths, k, c = 16, 240, (700,), 400, 256
    check(al.alt_corr_taps_form(w1, widths, k) == "general",
          f"alt_corr_taps ({w1} pixels, widths {widths}, {k} taps): the "
          f"tiled form was taken; the hold wants the general form")
    f1 = torch.randn((rows, w1, c), generator=g).cuda()
    f2 = torch.randn((rows, sum(widths), c), generator=g).cuda()
    taps = op_taps(1, rows, w1, widths, k, g, torch)

    def kern():
        return al.alt_corr_taps(f1, f2, taps, widths)

    def plain():
        return al.alt_corr_taps_plain(f1, f2, taps, widths)

    got, again, want = kern(), kern(), plain()
    torch.cuda.synchronize()
    err = rel_err(got, want, torch)
    check(int(got.isnan().sum()) == 1 and same_bits(got, again, torch),
          f"alt_corr_taps (general form): {int(got.isnan().sum())} NaN "
          f"entries (want 1), or two calls differ")
    check(err <= TAPS_TOL, f"alt_corr_taps disagrees with its plain version "
                           f"by {err} (general form)")
    ms, plain_ms = time_ms(kern, 20), time_ms(plain, 5)
    print(f"alt_corr_taps (general form, {dims(f1)} x {dims(f2)}, taps "
          f"{dims(taps)}) max rel {err:.3e} (tol {TAPS_TOL}); bitwise "
          f"repeatable; sha {digest(got)} ms {ms:.4f} plain_ms "
          f"{plain_ms:.4f} [{CARD}]")


def op_path_phase(inputs, torch):
    """The op path: per shape one ``pallas_alt_pyramid_flat`` forward and
    ``.backward()`` (fp32 or bf16 feature maps) and one
    ``instance_norm_act`` forward and ``.backward()``; each call launches
    exactly its kernels and no other counted kernel.  Returns launches
    per wrapper name for each path."""
    from raftstereo_tpu_torch.ops import alt_lookup as al
    from raftstereo_tpu_torch.ops import norm

    fns = counted_wrappers()
    by_path = {}
    for path, got_inputs in inputs.items():
        calls = []
        if "lookup" in got_inputs:
            f1, f2, taps, widths, (b, h, w) = got_inputs["lookup"]
            bf16 = f1.dtype == torch.bfloat16

            def lookup():
                a, c_ = (t.detach().requires_grad_() for t in (f1, f2))
                out = al.pallas_alt_pyramid_flat(
                    a, c_, taps.reshape(b, h, w, -1), widths,
                    out_dtype=torch.bfloat16 if bf16 else torch.float32)
                out.backward(torch.ones_like(out))
                check(a.grad.dtype == f1.dtype, f"op path {path}: "
                                                f"gradient {a.grad.dtype}")

            calls.append((lookup, dict(alt_corr_taps=1,
                                       alt_corr_taps_backward=1)))
        if "x" in got_inputs:
            x = got_inputs["x"]

            def inorm():
                xr = x.detach().requires_grad_(True)
                y = norm.instance_norm_act(xr, True)
                y.backward(torch.ones_like(y))

            calls.append((inorm, dict(in_norm_cluster=1)))
        total = dict.fromkeys((fn.__name__ for fn in fns), 0)
        for call, want in calls:
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
    for name in ("gru_update", "enc_conv_tc", "enc_conv", "enc_conv_wg"):
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
    rows += bf16_backward_phase(model, torch)
    vol_rows, op_vol_launches = vol_bf16_kernel_phase(cfg, lo_hw, torch)
    rows += vol_rows
    rows += encoder_bf16_kernel_phase(model, bucket, torch)
    rows += train_fused_bf16_kernel_phase(model, torch)

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
    ds3_rng, tier_rng = np.random.default_rng(3), np.random.default_rng(4)
    fused_bf16_rng = np.random.default_rng(5)
    bf16 = dict(compute_dtype="bfloat16", corr_dtype="bfloat16")
    for path, kw, per_request, r in (
            ("serve_fused", dict(fused_encoder=True),
             dict(FUSED_PER_REQUEST, alt_corr=ITERS, gru_update=ITERS), rng),
            ("serve_fused_ds3", dict(fused_encoder=True, n_downsample=3),
             dict(FUSED_PER_REQUEST_DS3, alt_corr=ITERS, gru_update=ITERS),
             ds3_rng),
            ("serve_pallas", dict(corr_implementation="pallas"),
             dict(vol_lookup=ITERS, gru_update=ITERS), vol_rng),
            ("serve_quant", dict(corr_implementation="auto",
                                 gru_backend="auto", corr_quant=True),
             dict(vol_lookup=ITERS, gru_update=ITERS, int8_corr_volume=1),
             vol_rng),
            ("serve_bf16", bf16, dict(alt_corr=ITERS, gru_update=ITERS),
             bf16_rng),
            ("serve_bf16_xla", dict(bf16, gru_backend="xla"),
             dict(alt_corr_epi=ITERS), bf16_rng),
            ("serve_bf16_pallas", dict(bf16, corr_implementation="pallas"),
             dict(vol_lookup=ITERS, gru_update=ITERS), tier_rng),
            ("serve_turbo", dict(bf16, corr_quant=True),
             dict(int8_corr_volume=1, vol_lookup=ITERS, gru_update=ITERS),
             tier_rng),
            ("serve_fused_bf16", dict(bf16, fused_encoder=True),
             dict(FUSED_PER_REQUEST, alt_corr=ITERS, gru_update=ITERS),
             fused_bf16_rng),
            ("serve_fused_ds3_bf16", dict(bf16, fused_encoder=True,
                                          n_downsample=3),
             dict(FUSED_PER_REQUEST_DS3, alt_corr=ITERS, gru_update=ITERS),
             fused_bf16_rng)):
        m = RAFTStereo(dataclasses.replace(cfg, **kw), device="cuda", seed=0)
        by_path[path] = serve_and_check(m, per_request, r)
        del m
        torch.cuda.empty_cache()
    by_path["serve_bf16_pallas_smooth"] = by_path["serve_bf16_pallas"]
    by_path.update(op_vol_launches)
    # The accuracy tiers of the fp32 flagship, through cli.certify and the
    # server's accuracy field, on the plain and on the fused encoders.
    for kw in ({}, dict(fused_encoder=True)):
        m = RAFTStereo(dataclasses.replace(cfg, **kw), device="cuda", seed=0)
        serve_tiers_phase(m, scfg, pairs, torch)
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
    for path, kw, runs, per_step in (
            ("train", {}, ((TRAIN_STEPS, 0), (RESUME_TO, TRAIN_STEPS)),
             lookup),
            ("train_pallas", dict(corr_implementation="pallas"),
             ((VOL_STEPS, 0),),
             dict(vol_lookup=TRAIN_ITERS, vol_lookup_backward=TRAIN_ITERS)),
            ("train_fused", dict(fused_encoder=True), ((FUSED_STEPS, 0),),
             dict(FUSED_PER_STEP, **lookup)),
            ("train_bf16", bf16, ((TRAIN_BF16_STEPS, 0),), lookup),
            ("train_fused_bf16", dict(bf16, fused_encoder=True),
             ((TRAIN_BF16_STEPS, 0),), dict(FUSED_PER_STEP, **lookup)),
            ("train_bf16_pallas", dict(bf16, corr_implementation="pallas"),
             ((TRAIN_BF16_STEPS, 0),),
             dict(vol_lookup=TRAIN_ITERS, vol_lookup_backward=TRAIN_ITERS))):
        mcfg = RAFTStereoConfig(**dict(dict(corr_implementation="pallas_alt",
                                            fused_encoder=False), **kw))
        by_path[path], secs, peak_gb = train_phase(torch, mcfg, runs,
                                                   per_step)
        walls[path] = (statistics.median(secs[1:]), peak_gb)
        # bf16 steps card vs CPU: (correlation dtype, config) each
        for corr_dtype, bkw in {
                "train_bf16": (("bfloat16", {}), ("float32", {})),
                "train_fused_bf16": (("bfloat16", dict(fused_encoder=True)),
                                     ("float32", dict(fused_encoder=True))),
                "train_bf16_pallas": (
                    ("bfloat16", dict(corr_implementation="pallas")),),
        }.get(path, ()):
            bf16_train_step_card_vs_cpu(torch, batch, corr_dtype, **bkw)
        if mcfg.compute_dtype != "bfloat16":
            train_step_card_vs_cpu(torch, batch, mcfg)
        torch.cuda.empty_cache()
    for path in ("train", "train_fused", "train_bf16", "train_fused_bf16",
                 "train_bf16_pallas"):
        print(f"{path}: median step wall (steps 2 on) {walls[path][0]:.3f}s, "
              f"peak memory {walls[path][1]:.2f} GB [{CARD}]")
    by_path["train_bf16_smooth"] = by_path["train_bf16"]

    # The op functions (rows 3, 4 with general taps, 8), then evaluation.
    op_rows, op_inputs = op_kernel_phase(lo_hw, torch)
    rows += op_rows
    by_path.update(op_path_phase(op_inputs, torch))
    by_path["op_train_bf16_smooth"] = by_path["op_train_bf16"]
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
