"""Row 2 (the fused GRU update) of one checkout of the PyTorch port, on
the card, for A/B comparisons of two trees in one call:

    python3 scripts/ab_gru_update.py ROOT [--report] [--profile]

ROOT is a checkout (or ``git archive``) holding ``raftstereo_tpu_torch``;
its kernels build under ROOT.  Prints one line: the update's CUDA-event
time (``chip_smoke.time_ms``, from this script's checkout) at the
serving grid in fp32 and bf16 (144x240, hd 128, ext 128, 36 correlation
channels) and at the KITTI evaluation grid in fp32 (96x312), each with
its largest difference from the plain version and the share of equal
elements.  ``--report`` prints the ptxas report of the build first,
``--profile`` one update's kernels by device time.  Run parent, change,
change, parent in one call and compare within it.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _short(name: str) -> str:
    """``k<...>`` of ``void (anonymous namespace)::k<...>(...)``."""
    i = name.find("::") + 2
    return name[i:name.find("(", i)]


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
    from raftstereo_tpu_torch import RAFTStereo, RAFTStereoConfig
    from raftstereo_tpu_torch.ops import _build, cuda_gru

    if not cuda_gru.__file__.startswith(root):
        raise RuntimeError(f"{cuda_gru.__file__} is not under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    libs = _build.build_all()
    if args.report:
        chip_smoke.build_report("gru_update", libs["gru_update"])
    model = RAFTStereo(RAFTStereoConfig(), device="cuda", seed=0)
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    out = []
    for (h, w), dt in (((144, 240), torch.float32),
                       ((144, 240), torch.bfloat16),
                       ((96, 312), torch.float32)):
        wpack = cuda_gru.pack_update_params(model.update_block, 128, dt)
        args_ = (torch.tanh(randn(1, h, w, 128)).to(dt),
                 torch.tanh(randn(1, h, w, 128)).to(dt),
                 randn(1, h, w, 36).to(dt),
                 (-60 * torch.rand((1, h, w, 1), generator=g)).to(dev),
                 randn(1, h, w, 128).to(dt), randn(1, h, w, 128).to(dt),
                 randn(1, h, w, 128).to(dt))
        got = cuda_gru.gru_update(*args_, wpack)
        want = cuda_gru.gru_update_plain(*args_, wpack)
        torch.cuda.synchronize()
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want)]
        eq = [float((a == b).float().mean()) for a, b in zip(got, want)]
        ms = chip_smoke.time_ms(lambda: cuda_gru.gru_update(*args_, wpack),
                                20)
        tag = f"{h}x{w} {str(dt)[6:]}"
        out.append(f"{tag} ms {ms:.4f} err {errs[0]:.2e}/{errs[1]:.2e} "
                   f"equal {eq[0]:.4f}/{eq[1]:.4f}")
        if args.profile:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
                cuda_gru.gru_update(*args_, wpack)
                torch.cuda.synchronize()
            print(f"  {tag}: " + "; ".join(
                f"{_short(ev.name)} {ev.device_time_total / 1e3:.3f}"
                for ev in p.events()
                if ev.device_type == torch.autograd.DeviceType.CUDA))
    print(f"{root} [{torch.cuda.get_device_name(0)}] " + " | ".join(out),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
