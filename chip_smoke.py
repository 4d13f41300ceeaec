#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, none caught: (1) print the card's name and power limit; (2) build
the CUDA kernels from ``raftstereo_tpu_torch/csrc``; (3) hold each kernel
against its plain PyTorch version on the card at the shapes its main path
gives it, and time both: the serving path's lookup and fused update (a
540x960 request pads to the 576x960 bucket, so the 1/4-resolution grid is
144x240 with C=256 and hidden 128), and the training path's lookup and
its backward (batch 6 of 320x720 crops: 480 rows of 180 pixels, C=256),
the backward also bitwise repeatable; (4) serve three 540x960, 32-iteration
requests of the flagship model through ``/predict``, check that they are
finite, bitwise equal to a direct ``BatchEngine.infer_batch`` call, and
that each serving kernel launched exactly 32 times per request; (5) hold
the card's forward against the port's CPU forward (plain versions) on a
small pair; (6) train the flagship model through
``cli.train.train`` on ``ShiftStereoDataset`` at the recipe shape (batch
6, 320x720, 16 iterations): 6 steps, then a second call that resumes from
the step-6 checkpoint and runs to step 8; every loss finite, the lookup
forward and backward kernels launched exactly 16 times per step each;
(7) hold one train step's loss and gradients on the card against the CPU
(plain versions) on a 64x96 pair.  Prints a ``{"kernels": [...]}`` line,
one row per kernel and path (the path's launches beside the times and
bound at its shapes), and, last, ``{"ok": true, "device": ...}``.  Exits non-zero, printing no
result, without a GPU or without the repo.
"""

from __future__ import annotations

import base64
import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np

# H100 SXM data sheet: HBM rate and fp32 rate outside the tensor cores
# (TF32 is off on the port's fp32 path).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

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


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, reps: int, rounds: int = 5) -> float:
    """Device time of one ``fn()`` call in ms: CUDA events around ``reps``
    back-to-back calls (the host enqueues ahead of the card, so launch
    overhead hides behind the work), divided by ``reps``; the median of
    ``rounds`` such rounds, after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
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
    print(f"alt_corr ({path}) ms {ms:.4f} plain_ms {plain_ms:.4f}")
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


def kernel_phase(model, lo_hw, torch):
    """Each kernel against its plain version at each main path's shapes;
    one row per kernel and path."""
    from raftstereo_tpu_torch.ops import cuda_alt, cuda_gru
    from raftstereo_tpu_torch.ops.corr import build_corr_state

    cfg = model.config
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    h, w = lo_hw
    c, hd = model.feature_dim, cfg.hidden_dims[0]

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

    # -- update
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
    err = max(float((hk - hp).abs().max()), float((dk - dp).abs().max()))
    scale = max(1.0, float(hp.abs().max()), float(dp.abs().max()))
    print(f"gru_update max_abs_err {err:.3e} (tol {UPDATE_TOL} x {scale:.3g})")
    check(err <= UPDATE_TOL * scale,
          f"gru_update disagrees with its plain version by {err}")
    ms = time_ms(lambda: cuda_gru.gru_update(*args, wpack), 20)
    plain_ms = time_ms(lambda: cuda_gru.gru_update_plain(*args, wpack), 10)
    print(f"gru_update ms {ms:.4f} plain_ms {plain_ms:.4f}")
    macs = (cfg.cor_planes * 64 + 9 * 64 * 64 + 49 * 64 + 9 * 64 * 64
            + 9 * 128 * 126 + 9 * (hd + 127 + e) * 3 * hd
            + 9 * hd * 256 + 9 * 256 * 2)
    flops = h * w * (2 * macs + 12 * hd)
    nbytes = 4 * (sum(a.numel() for a in args if a is not None)
                  + sum(v.numel() for v in wpack.values())
                  + hk.numel() + dk.numel())
    rows.append(dict(name="gru_update", path="serve", route="cuda",
                     source="raftstereo_tpu_torch/csrc/gru_update.cu",
                     replaces="raftstereo_tpu/ops/pallas_gru.py:261",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     **dict(zip(("bound_ms", "bound_by"),
                                bound(nbytes, flops))),
                     library_ms=None))

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
    return rows


def train_phase(torch):
    """The training path: 6 steps of the recipe, then a resume to 8."""
    from raftstereo_tpu_torch import RAFTStereoConfig
    from raftstereo_tpu_torch.cli import train as cli_train
    from raftstereo_tpu_torch.config import TrainConfig
    from raftstereo_tpu_torch.data.synthetic import ShiftStereoDataset
    from raftstereo_tpu_torch.ops import cuda_alt

    mcfg = RAFTStereoConfig(corr_implementation="pallas_alt",
                            fused_encoder=False)
    dataset = ShiftStereoDataset(n=2 * TRAIN_BATCH, hw=TRAIN_HW,
                                 max_disp=48.0, seed=0)
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        for last in (TRAIN_STEPS, RESUME_TO):
            # The loop stops once the step count exceeds num_steps.
            cfg = TrainConfig(name="smoke", batch_size=TRAIN_BATCH,
                              image_size=TRAIN_HW, train_iters=TRAIN_ITERS,
                              num_steps=last - 1, checkpoint_dir=tmp)
            cuda_alt.alt_corr.launches = 0
            cuda_alt.alt_corr_backward.launches = 0
            t0 = time.perf_counter()
            state = cli_train.train(mcfg, cfg, dataset=dataset, num_workers=0,
                                    no_validation=True, device="cuda",
                                    log_dir=os.path.join(tmp, "runs"))
            counts[last] = (cuda_alt.alt_corr.launches,
                            cuda_alt.alt_corr_backward.launches)
            print(f"train() to step {state.step} in "
                  f"{time.perf_counter() - t0:.1f}s; launches "
                  f"alt_corr/alt_corr_bwd {counts[last]}")
            check(state.step == last, f"train() stopped at step {state.step}"
                                      f", want {last}")
        saved = sorted(os.listdir(os.path.join(tmp, "smoke")))
        # Both calls append their per-step scalars to the run's JSONL
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
    steps = list(range(1, RESUME_TO + 1))
    check(sorted(secs) == steps, f"steps run {sorted(secs)}")
    check(sorted(loss) == steps and all(np.isfinite(v) for v in loss.values()),
          f"non-finite or skipped training steps: {loss}")
    for last, first in ((TRAIN_STEPS, 0), (RESUME_TO, TRAIN_STEPS)):
        want = (last - first) * TRAIN_ITERS
        check(counts[last] == (want, want),
              f"steps {first + 1}..{last}: lookup launches "
              f"{counts[last]}, want {want} each")
    return {"alt_corr": sum(v[0] for v in counts.values()),
            "alt_corr_bwd": sum(v[1] for v in counts.values())}


def train_step_card_vs_cpu(torch, rng):
    """One train step's loss and gradients, card (kernels) vs CPU (plain
    versions), flagship widths, 3 iterations, a 64x96 pair."""
    from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig
    from raftstereo_tpu_torch.train.loss import sequence_loss

    model = RAFTStereo(RAFTStereoConfig(), device="cuda", seed=1)
    cpu_model = copy.deepcopy(model).to("cpu")
    batch = [torch.from_numpy(rng.uniform(0, 255, (1, 64, 96, 3))
                              .astype(np.float32)) for _ in range(2)]
    batch += [torch.from_numpy(-rng.uniform(1, 30, (1, 64, 96, 1))
                               .astype(np.float32)), torch.ones(1, 64, 96)]
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
    print(f"train step card vs cpu: loss {lg:.6g} vs {lc:.6g}; gradient "
          f"max_abs_err {gerr:.3e} (tol {STEP_GRAD_TOL} x {gmax:.3g})")
    check(abs(lg - lc) <= STEP_LOSS_TOL * abs(lc),
          f"train step loss differs card vs CPU: {lg} vs {lc}")
    check(gerr <= STEP_GRAD_TOL * gmax,
          f"train step gradients differ card vs CPU by {gerr}")


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
    from raftstereo_tpu_torch.ops import _build, cuda_alt, cuda_gru
    from raftstereo_tpu_torch.ops.image import BucketPadder
    from raftstereo_tpu_torch.serve.server import build_server, decode_array

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
    for name, path in sorted(libs.items()):
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    cfg = RAFTStereoConfig(corr_implementation="pallas_alt",
                           gru_backend="fused")
    model = RAFTStereo(cfg, device="cuda", seed=0)
    scfg = ServeConfig(port=0, buckets=(IMAGE_HW,), serve_iters=ITERS)
    bucket = BucketPadder(IMAGE_HW, divis_by=scfg.divis_by,
                          bucket_multiple=scfg.bucket_multiple).bucket_hw
    lo_hw = (bucket[0] // cfg.factor, bucket[1] // cfg.factor)
    print(f"bucket {bucket} -> grid {lo_hw}")
    rows = kernel_phase(model, lo_hw, torch)

    t0 = time.perf_counter()
    server = build_server(model, scfg, device="cuda")
    print(f"server warm in {time.perf_counter() - t0:.1f}s")
    server.start()
    rng = np.random.default_rng(0)
    pairs = [tuple(rng.uniform(0, 255, IMAGE_HW + (3,)).astype(np.float32)
                   for _ in range(2)) for _ in range(REQUESTS)]
    try:
        cuda_alt.alt_corr.launches = 0
        cuda_gru.gru_update.launches = 0
        replies = []
        for left, right in pairs:
            t0 = time.perf_counter()
            replies.append(post_predict(server.port, left, right))
            print(f"/predict {time.perf_counter() - t0:.3f}s "
                  f"meta {replies[-1]['meta']}")
        launches = {"alt_corr": cuda_alt.alt_corr.launches,
                    "gru_update": cuda_gru.gru_update.launches}
    finally:
        server.shutdown()
        server.server_close()
    print(f"launches {launches}")
    for name, count in launches.items():
        check(count == REQUESTS * ITERS,
              f"{name} launched {count} times, want {REQUESTS * ITERS}")
    for (left, right), rep in zip(pairs, replies):
        disp = decode_array(rep["disparity"])
        check(disp.shape == IMAGE_HW, f"reply shape {disp.shape}")
        check(bool(np.isfinite(disp).all()), "non-finite disparity")
        (direct,) = server.engine.infer_batch([(left, right)], ITERS)
        check(np.array_equal(disp, direct),
              "reply differs from a direct engine call")
    print("replies finite and bitwise equal to direct engine calls")

    # The card's forward (kernels) against the CPU forward (plain versions)
    # on a small pair: the repo's own reference for the whole path.
    cpu_model = copy.deepcopy(model).to("cpu")
    i1 = torch.from_numpy(rng.uniform(0, 255, (1, 64, 96, 3))
                          .astype(np.float32))
    i2 = torch.from_numpy(rng.uniform(0, 255, (1, 64, 96, 3))
                          .astype(np.float32))
    lo_g, up_g = model(i1.cuda(), i2.cuda(), iters=4)
    lo_c, up_c = cpu_model(i1, i2, iters=4)
    for name, a, b, tol in (("low-res", lo_g.cpu(), lo_c, FORWARD_TOL[0]),
                            ("full-res", up_g.cpu(), up_c, FORWARD_TOL[1])):
        err = float((a - b).abs().max())
        scale = max(1.0, float(b.abs().max()))
        print(f"forward {name} card vs cpu max_abs_err {err:.3e} "
              f"(tol {tol} x {scale:.3g})")
        check(bool(torch.isfinite(a).all()) and err <= tol * scale,
              f"card forward differs from the CPU forward ({name}: {err})")

    del model, cpu_model, server
    torch.cuda.empty_cache()
    train_launches = train_phase(torch)
    train_step_card_vs_cpu(torch, rng)

    # Each row's launches are those of its path's run, beside the times
    # and bound measured at that path's shapes.
    by_path = {"serve": launches, "train": train_launches}
    for row in rows:
        row["launches"] = by_path[row["path"]][row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
