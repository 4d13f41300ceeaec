"""Rows 1, 6 and 4 (radial) of one checkout of the PyTorch port, on the
card, for A/B comparisons of two trees in one call:

    python3 scripts/ab_lookup.py ROOT [--report] [--profile] [--request]

ROOT is a checkout (or ``git archive``) holding ``raftstereo_tpu_torch``;
its kernels build under ROOT.  Prints one line per tree with the
CUDA-event time (``chip_smoke.time_ms``, ROOT's where ROOT has a
``chip_smoke.py``, else this script's checkout's) of:

- row 1, the on-demand lookup (``alt_corr``), at the serving grid
  (1x144x240) and the training grid (6x80x180), each with fp32 feature
  maps and output and with bf16 ones, on the smoke's random disparity
  field (x = column - 60 U(0, 1)) and on a smooth one (a low-frequency
  sine of x and y in [-60, 0]), and at the evaluation grid (1x96x312,
  fp32, random), each with its largest error against the plain version
  (absolute in fp32, in bf16 ulps of max(1, |plain|) in bf16);
- row 6, the volume lookup's backward (``vol_lookup_backward``), at the
  training recipe (6x80x180, levels 180/90/45/22), with whether it is
  bitwise equal to the plain version;
- row 4 radial, the lookup's backward (``alt_corr_backward``), at the
  recipe (C=256), with a SHA-256 digest of its two outputs: equal digests
  from two trees mean bitwise equal gradients.

All with 4 levels of radius 4.  The inputs come from this script's
seeded generator, so both trees see the same ones.  ``--report`` prints
the ptxas report (registers, shared memory, spills) of the three
libraries first, ``--profile`` each timed call's kernels by device time.
A tree whose ``csrc`` holds only some of the three sources (a form being
tried) times only their rows.  ``--request`` instead serves one
flagship request through the tree's
model (seeded weights, a seeded random 576x960 pair, 32 iterations),
records the 32 lookups' coordinates, prints their disparity statistics
and the share of (32-pixel tile, level) spans that outgrow this
checkout's staging buffer, and times the tree's lookup on each recorded
input: the lookup as a request drives it.  Run parent, change, change,
parent in one call and compare within it.
"""

from __future__ import annotations

import argparse
import hashlib
import math
import os
import re
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, LEVELS, RADIUS = 256, 4, 4
LOOKUP_SHAPES = (("serve", 1, 144, 240), ("train", 6, 80, 180))
EVAL_SHAPE = ("eval", 1, 96, 312)
RECIPE = (6, 80, 180)
LIBS = ("alt_corr", "corr_vol_bwd", "alt_corr_bwd")


def _short(name: str) -> str:
    """``k<...>`` of ``void (anonymous namespace)::k<...>(...)``."""
    i = name.find("::") + 2
    return name[i:name.find("(", i)]


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def field(kind, b, h, w, g, torch):
    """x (b, h, w): column minus a disparity in [-60, 0], random per pixel
    or a low-frequency sine of x and y."""
    xx = torch.arange(w, dtype=torch.float32)
    if kind == "random":
        return xx - 60.0 * torch.rand((b, h, w), generator=g)
    yy = torch.arange(b * h, dtype=torch.float32).reshape(b, h, 1)
    return xx - 30.0 + 30.0 * torch.sin(2 * math.pi * (xx / 97.0
                                                         + yy / 13.0))


def wide_share(xs, widths, radius) -> str:
    """How many (tile, level) spans of the recorded coordinates outgrow
    the staging buffer, by this checkout's ``alt_corr.cu`` constants."""
    import numpy as np

    src = open(os.path.join(HERE, "raftstereo_tpu_torch", "csrc",
                            "alt_corr.cu")).read()
    tp, cap = (int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
               for n in ("kTilePix", "kSpanRows"))
    wide = total = 0
    np.seterr(invalid="ignore")  # NaN coordinates meet no level
    for row in np.concatenate([x.reshape(-1, x.shape[-1]) for x in xs]):
        for p0 in range(0, len(row), tp):
            b0s = [np.floor(row[p0:p0 + tp] / 2 ** lvl)
                   for lvl in range(len(widths))]
            used = 0
            for b0, w in zip(b0s, widths):
                hit = (b0 - radius <= w - 1) & (b0 + radius + 1 >= 0)
                if not hit.any():
                    continue
                n = (min(int(b0[hit].max()) + radius + 1, w - 1)
                     - max(int(b0[hit].min()) - radius, 0) + 1)
                total += 1
                if used + n <= cap:
                    used += n
                else:
                    wide += 1
    return f"{wide}/{total}"


def request(torch, chip_smoke, cuda_alt, root) -> None:
    """``--request``: the lookups of one served flagship request."""
    import numpy as np

    from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig

    seen, orig = [], cuda_alt.alt_corr

    def record(fmap1, f2cat, widths, x, radius, *a, **k):
        seen.append((fmap1, f2cat, tuple(widths), x.clone(), radius))
        return orig(fmap1, f2cat, widths, x, radius, *a, **k)

    record.launches = 0
    cuda_alt.alt_corr = record  # _AltCorrFunction calls it by this name
    model = RAFTStereo(RAFTStereoConfig(corr_implementation="pallas_alt",
                                        gru_backend="fused"),
                       device="cuda", seed=0)
    rng = np.random.default_rng(0)
    left, right = (torch.from_numpy(rng.uniform(0, 255, (1, 576, 960, 3))
                                    .astype(np.float32)).cuda()
                   for _ in range(2))
    with torch.inference_mode():
        model(left, right, iters=32, test_mode=True)
    torch.cuda.synchronize()
    cuda_alt.alt_corr = orig
    xs = [s[3].cpu().numpy() for s in seen]
    disp = np.stack(xs) - np.arange(xs[0].shape[-1])
    ms = [chip_smoke.time_ms(lambda s=s: orig(*s[:4], s[4]), 20, 3)
          for s in seen]
    print(f"{root} [{torch.cuda.get_device_name(0)}] request: {len(seen)} "
          f"lookups of {tuple(seen[0][3].shape)}, disparity mean "
          f"{disp.mean():.1f} std {disp.std():.1f} (last lookup "
          f"{disp[-1].mean():.1f}), spans past the staging buffer "
          f"{wide_share(xs[::4], seen[0][2], seen[0][4])} of every 4th "
          f"lookup's; kernel time summed over the recorded inputs "
          f"{sum(ms):.3f} ms (first {ms[0]:.4f}, last {ms[-1]:.4f}, max "
          f"{max(ms):.4f})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--request", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import torch

    import chip_smoke
    from raftstereo_tpu_torch.device import fp32_numerics
    from raftstereo_tpu_torch.ops import _build, cuda_alt, cuda_vol
    from raftstereo_tpu_torch.ops.corr import build_corr_state

    if not cuda_alt.__file__.startswith(root):
        raise RuntimeError(f"{cuda_alt.__file__} is not under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    fp32_numerics()  # the plain versions' matmuls in fp32, not TF32
    libs = _build.build_all()
    if args.request:
        request(torch, chip_smoke, cuda_alt, root)
        return 0
    if args.report:
        for name in (n for n in LIBS if n in libs):
            log = libs[name].with_suffix(".log").read_text()
            for line in log.splitlines():
                if ("Function properties" in line or "registers" in line
                        or "spill" in line):
                    print(f"  {name}: {line.strip()}")
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    out = []

    def profile(label, fn):
        if not args.profile:
            return
        cuda = torch.profiler.ProfilerActivity.CUDA
        with torch.profiler.profile(activities=[cuda]) as prof:
            fn()
            torch.cuda.synchronize()
        print(f"  {label}: " + "; ".join(
            f"{_short(ev.name)} {ev.device_time_total / 1e3:.3f}"
            for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA))

    if "alt_corr" in libs:
        # -- row 1
        cases = [(s, dt, f) for s in LOOKUP_SHAPES
                 for dt in (torch.float32, torch.bfloat16)
                 for f in ("random", "smooth")]
        cases.append((EVAL_SHAPE, torch.float32, "random"))
        states = {}
        for (label, b, h, w), dtype, kind in cases:
            key = (label, dtype)
            if key not in states:
                states.clear()
                torch.cuda.empty_cache()
                states[key] = build_corr_state(
                    torch.randn((b, h, w, C), generator=g).to(dev),
                    torch.randn((b, h, w, C), generator=g).to(dev), LEVELS,
                    corr_dtype=dtype)
            st = states[key]
            x = field(kind, b, h, w, g, torch).to(dev).contiguous()

            def kern():
                return cuda_alt.alt_corr(st.fmap1, st.f2cat, st.widths, x,
                                         RADIUS, dtype)

            got = kern()
            want = cuda_alt.alt_corr_plain(st.fmap1, st.f2cat, st.widths, x,
                                           RADIUS, dtype)
            torch.cuda.synchronize()
            if dtype == torch.bfloat16:
                err = f"{chip_smoke.ulps(got, want):.2f}ulp"
            else:
                err = f"{float((got - want).abs().max()):.1e}"
            ms = chip_smoke.time_ms(kern, 50)
            tag = "bf16" if dtype == torch.bfloat16 else "fp32"
            out.append(f"alt_corr {label} {tag} {kind} {b}x{h}x{w} ms "
                       f"{ms:.4f} err {err}")
            profile(f"alt_corr {label} {tag} {kind}", kern)
            del x, got, want
        states.clear()
        torch.cuda.empty_cache()

    # -- row 6 and row 4 radial at the recipe
    b, h, w = RECIPE
    st = build_corr_state(torch.randn((b, h, w, C), generator=g).to(dev),
                          torch.randn((b, h, w, C), generator=g).to(dev),
                          LEVELS)
    x = field("random", b, h, w, g, torch).to(dev).contiguous()
    gout = torch.randn((b, h, w, LEVELS * (2 * RADIUS + 1)),
                       generator=g).to(dev)

    if "corr_vol_bwd" in libs:
        def vol_bwd():
            return cuda_vol.vol_lookup_backward(x, gout, st.widths, RADIUS)

        k1, k2 = vol_bwd(), vol_bwd()
        want = cuda_vol.vol_lookup_backward_plain(x, gout, st.widths, RADIUS)
        torch.cuda.synchronize()
        same = (torch.equal(k1.view(torch.int32), want.view(torch.int32))
                and torch.equal(k1.view(torch.int32), k2.view(torch.int32)))
        ms = chip_smoke.time_ms(vol_bwd, 20)
        out.append(f"vol_lookup_bwd {b}x{h}x{w} ms {ms:.4f} bitwise_plain "
                   f"{same}")
        profile("vol_lookup_bwd", vol_bwd)
        del k1, k2, want

    if "alt_corr_bwd" in libs:
        def alt_bwd():
            return cuda_alt.alt_corr_backward(st.fmap1, st.f2cat, st.widths, x,
                                              gout, RADIUS)

        k1, k2 = alt_bwd(), alt_bwd()
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(k1, k2))
        ms = chip_smoke.time_ms(alt_bwd, 20)
        out.append(f"alt_corr_bwd {b}x{h}x{w} ms {ms:.4f} repeatable {same} "
                   f"sha {digest(k1)}")
        profile("alt_corr_bwd", alt_bwd)
    print(f"{root} [{torch.cuda.get_device_name(0)}] " + " | ".join(out),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
