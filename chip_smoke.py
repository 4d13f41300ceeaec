#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, none caught: (1) print the card's name and power limit; (2) build
the CUDA kernels from ``raftstereo_tpu_torch/csrc``; (3) hold each kernel
against its plain PyTorch version on the card at the shapes the serving
path gives it (a 540x960 request pads to the 576x960 bucket, so the
1/4-resolution grid is 144x240 with C=256 and hidden 128), and time both;
(4) serve three 540x960, 32-iteration requests of the flagship model
through ``/predict``, check that they are finite, bitwise equal to a
direct ``BatchEngine.infer_batch`` call, and that each kernel launched
exactly 32 times per request; (5) hold the card's forward against the
port's CPU forward (plain versions) on a small pair.  Prints a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, without a GPU or without the repo.
"""

from __future__ import annotations

import base64
import copy
import json
import os
import statistics
import subprocess
import sys
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


def kernel_phase(model, lo_hw, torch):
    """Each kernel against its plain version at the main path's shapes."""
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
    # -- lookup
    state = build_corr_state(randn(1, h, w, c), randn(1, h, w, c),
                             cfg.corr_levels)
    disp = -60.0 * torch.rand((1, h, w), generator=g).to(dev)
    x = (torch.arange(w, device=dev, dtype=torch.float32) + disp).contiguous()
    r = cfg.corr_radius

    def kern():
        return cuda_alt.alt_corr(state.fmap1, state.f2cat, state.widths, x, r)

    def plain():
        return cuda_alt.alt_corr_plain(state.fmap1, state.f2cat,
                                       state.widths, x, r)

    err = float((kern() - plain()).abs().max())
    torch.cuda.synchronize()
    print(f"alt_corr max_abs_err {err:.3e} (tol {LOOKUP_TOL})")
    check(err <= LOOKUP_TOL, f"alt_corr disagrees with its plain version "
                             f"by {err}")
    ms, plain_ms = time_ms(kern, 50), time_ms(plain, 10)
    print(f"alt_corr ms {ms:.4f} plain_ms {plain_ms:.4f}")
    k = 2 * r + 1
    valid = 0
    for lvl, w2 in enumerate(state.widths):
        b0 = torch.floor(x / 2 ** lvl)
        for d in range(k + 1):
            j = b0 + (d - r)
            valid += int(((j >= 0) & (j <= w2 - 1)).sum())
    npix = h * w
    nbytes = 4 * (state.fmap1.numel() + state.f2cat.numel() + x.numel()
                  + npix * len(state.widths) * k)
    flops = 2 * c * valid + 3 * npix * len(state.widths) * k
    rows.append(dict(name="alt_corr", route="cuda",
                     source="raftstereo_tpu_torch/csrc/alt_corr.cu",
                     replaces="raftstereo_tpu/ops/pallas_alt.py:158",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     **dict(zip(("bound_ms", "bound_by"),
                                bound(nbytes, flops))),
                     library_ms=None))

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
    flops = npix * (2 * macs + 12 * hd)
    nbytes = 4 * (sum(a.numel() for a in args if a is not None)
                  + sum(v.numel() for v in wpack.values())
                  + hk.numel() + dk.numel())
    rows.append(dict(name="gru_update", route="cuda",
                     source="raftstereo_tpu_torch/csrc/gru_update.cu",
                     replaces="raftstereo_tpu/ops/pallas_gru.py:261",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     **dict(zip(("bound_ms", "bound_by"),
                                bound(nbytes, flops))),
                     library_ms=None))
    return rows


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
    for row in rows:
        row["launches"] = launches[row["name"]]

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

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
