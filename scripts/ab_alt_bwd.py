"""Row 4, radial taps (``alt_corr_backward``, the VJP of the model's
lookup) of one checkout of the PyTorch port, on the card, for A/B
comparisons of two trees in one call:

    python3 scripts/ab_alt_bwd.py ROOT [--report] [--profile]

ROOT is a checkout (or ``git archive``) holding ``raftstereo_tpu_torch``;
its kernels build under ROOT.  Prints one line per tree: the kernel's
CUDA-event time (``chip_smoke.time_ms``, from this script's checkout) at
the training recipe's shape (6x80 rows of 180 pixels, C=256, 4 levels of
radius 4) and at evaluation-width crops (6x80 rows of 312), each with its
largest error against the plain version relative to max(1, |plain|),
whether two calls are bitwise equal, and a SHA-256 digest of the two
outputs' bytes: equal digests from two trees mean bitwise equal
gradients.  The inputs come from this script's seeded generator, so both
trees see the same ones.  ``--report`` prints the ptxas report
(registers, shared memory, spills) of the library first, ``--profile``
each call's kernels by device time.  Run parent, change, change, parent
in one call and compare within it.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (("recipe", 6, 80, 180), ("w312", 6, 80, 312))
C, LEVELS, RADIUS = 256, 4, 4


def _short(name: str) -> str:
    """``k<...>`` of ``void (anonymous namespace)::k<...>(...)``."""
    i = name.find("::") + 2
    return name[i:name.find("(", i)]


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import torch

    import chip_smoke
    from raftstereo_tpu_torch.device import fp32_numerics
    from raftstereo_tpu_torch.ops import _build, cuda_alt
    from raftstereo_tpu_torch.ops.corr import build_corr_state

    if not cuda_alt.__file__.startswith(root):
        raise RuntimeError(f"{cuda_alt.__file__} is not under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    fp32_numerics()  # the plain version's matmuls in fp32, not TF32
    libs = _build.build_all()
    if args.report:
        log = libs["alt_corr_bwd"].with_suffix(".log").read_text()
        for line in log.splitlines():
            if ("Function properties" in line or "registers" in line
                    or "spill" in line):
                print(f"  alt_corr_bwd: {line.strip()}")
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    out = []
    for label, b, h, w in SHAPES:
        st = build_corr_state(torch.randn((b, h, w, C), generator=g).to(dev),
                              torch.randn((b, h, w, C), generator=g).to(dev),
                              LEVELS)
        x = (torch.arange(w, dtype=torch.float32)
             - 60.0 * torch.rand((b, h, w), generator=g)).to(dev)
        gout = torch.randn((b, h, w, LEVELS * (2 * RADIUS + 1)),
                           generator=g).to(dev)

        def kern():
            return cuda_alt.alt_corr_backward(st.fmap1, st.f2cat, st.widths,
                                              x, gout, RADIUS)

        k1, k2 = kern(), kern()
        want = cuda_alt.alt_corr_backward_plain(st.fmap1, st.f2cat,
                                                st.widths, x, gout, RADIUS)
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(k1, k2))
        err = max(float((a - p).abs().max()) / max(1.0, float(p.abs().max()))
                  for a, p in zip(k1, want))
        ms = chip_smoke.time_ms(kern, 20)
        out.append(f"{label} {b}x{h}x{w} ms {ms:.4f} err {err:.2e} "
                   f"repeatable {same} sha {digest(k1)}")
        if args.profile:
            cuda = torch.profiler.ProfilerActivity.CUDA
            with torch.profiler.profile(activities=[cuda]) as prof:
                kern()
                torch.cuda.synchronize()
            print(f"  {label}: " + "; ".join(
                f"{_short(ev.name)} {ev.device_time_total / 1e3:.3f}"
                for ev in prof.events()
                if ev.device_type == torch.autograd.DeviceType.CUDA))
        del st, x, gout, k1, k2, want
        torch.cuda.empty_cache()
    print(f"{root} [{torch.cuda.get_device_name(0)}] " + " | ".join(out),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
