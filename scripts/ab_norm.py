"""Row 8 (the stand-alone instance norm, ``norm.instance_norm_act``) of one
checkout of the PyTorch port, on the card, for A/B comparisons of two
trees in one call:

    python3 scripts/ab_norm.py ROOT [--report]

ROOT is a checkout (or ``git archive``) holding ``raftstereo_tpu_torch``;
its kernels build under ROOT.  Prints one line per tree with, at the
smoke's op shapes (2x64x288x480, fnet's first norm at a 576x960 bucket,
and 12x64x160x360, the training recipe's; fp32 and bf16), relu off and
on: the CUDA-event time of one ``instance_norm_act`` call as the tree's
wrapper runs it (``time_ms`` of this script's ``chip_smoke.py``:
back-to-back calls, so a tensor under the 50 MB L2 cache is found there),
whether a second call gives equal bits, a SHA-256 digest of its output
(equal digests from two trees: bitwise equal outputs) and its largest
error against the plain version on the card, relative to max(1,
|plain|).  Where the tree has the one-pass cluster form
(``norm.in_norm_cluster``), relu off is also timed in each form forced
(``cluster``, and ``two`` for ``in_stats`` then ``in_apply``); shapes
under 50 MB are also timed with the cache flushed between calls
(``cold``, ``time_cold_ms``).  The inputs come from this script's seeded
generator, so both trees see the same ones.  ``--report`` prints the
ptxas report of ``inorm.cu`` first.  Run parent, change, change, parent
in one call and compare within it.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (label, shape, dtype)
SHAPES = (("op_serve", (2, 64, 288, 480), "float32"),
          ("op_train", (12, 64, 160, 360), "float32"),
          ("op_serve_bf16", (2, 64, 288, 480), "bfloat16"),
          ("op_train_bf16", (12, 64, 160, 360), "bfloat16"))


def digest(t) -> str:
    import torch

    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()[:16]


def smoke():
    """This script's checkout's ``chip_smoke`` (its timers), whatever ROOT
    holds."""
    spec = importlib.util.spec_from_file_location(
        "_ab_norm_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--report", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from raftstereo_tpu_torch.ops import _build, norm

    if not norm.__file__.startswith(root):
        raise RuntimeError(f"{norm.__file__} is not under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    cs = smoke()
    libs = _build.build_all()
    if args.report:
        for line in libs["inorm"].with_suffix(".log").read_text().splitlines():
            if ("Function properties" in line or "registers" in line
                    or "spill" in line):
                print(f"  inorm: {line.strip()}")
    forms = hasattr(norm, "in_norm_cluster")
    g = torch.Generator().manual_seed(0)
    out = []
    for label, shape, dt in SHAPES:
        dtype = getattr(torch, dt)
        x = (torch.randn(shape, generator=g) * 1.5 + 0.4).to("cuda", dtype)
        small = x.numel() * x.element_size() < cs.L2_BYTES
        for relu in (False, True):
            def kern(relu=relu):
                return norm.instance_norm_act(x, relu)

            y1, y2 = kern(), kern()
            want = norm.in_apply_plain(x, *norm.in_stats_plain(x), relu)
            torch.cuda.synchronize()
            err = float(((y1.float() - want.float()).abs()
                         / want.float().abs().clamp_min(1.0)).max())
            line = (f"{label} relu {int(relu)} ms "
                    f"{cs.time_ms(kern, 20):.4f} repeat "
                    f"{torch.equal(y1, y2)} sha {digest(y1)} err {err:.2e}")
            if not relu:
                timed = {"cluster": lambda: norm.in_norm_cluster(x),
                         "two": lambda: norm.in_apply(x, *norm.in_stats(x))}
                if forms:
                    line += "".join(f" {k} {cs.time_ms(f, 20):.4f}"
                                    for k, f in timed.items())
                if small:
                    line += f" cold {cs.time_cold_ms(kern):.4f}"
                    if forms:
                        line += f" cold_two {cs.time_cold_ms(timed['two']):.4f}"
            out.append(line)
        del x, y1, y2, want
        torch.cuda.empty_cache()
    print(f"{root} [{torch.cuda.get_device_name(0)}] " + " | ".join(out),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
