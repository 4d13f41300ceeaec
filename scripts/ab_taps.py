"""Rows 3 and 4 (general taps) of one checkout of the PyTorch port, on the
card, for A/B comparisons of two trees in one call:

    python3 scripts/ab_taps.py ROOT [--report] [--forms]

ROOT is a checkout (or ``git archive``) holding ``raftstereo_tpu_torch``;
its kernels build under ROOT.  Prints one line per tree with the
CUDA-event time (``chip_smoke.time_ms``, ROOT's where ROOT has a
``chip_smoke.py``, else this script's checkout's) of:

- row 3, the lookup at caller-given taps (``alt_corr_taps``), at the
  smoke's op shapes: the serving pyramid (144 rows of 240 pixels, level
  widths 240/120/60/30) in fp32 and with bf16 feature maps and output,
  and the training shape (480 rows of 180, 180/90/45/22) in fp32;
- row 4 with general taps (``alt_corr_taps_backward``) at the training
  shape;

C = 256, 4 levels of 9 taps, each on two tap patterns: ``random`` (the
smoke's: per level 5 taps around a random centre, 3 random reals in
[-3, w + 3] and one integer) and ``smooth`` (centres that follow a slowly
varying disparity along each row, taps 5-8 within 4 of the centre); both
with one far tap and one NaN tap.  Each with whether a second call gives
equal bits and a SHA-256 digest of its output (df1 and df2 for row 4):
equal digests from two trees mean bitwise equal outputs.  The inputs
come from this script's seeded generators, so both trees see the same
ones.  ``--report`` prints the ptxas report (registers, shared memory,
spills) of the two libraries first.  A tree whose ``csrc`` holds only one
of the two sources (a form being tried) times only its rows.  Run
parent, change, change, parent in one call and compare within it.

``--forms`` times row 3 instead at shapes with many distinct columns a
pixel (FORM_SHAPES: 144 rows of 240 pixels, C = 256, the serving
pyramid at 36, 72 and 144 random taps a level, a 1000-wide level at 100
taps, levels 600 and 300 wide at 150, a 2000-wide level at 40, levels
100 and 50 wide at 300; the evaluation pyramid 312/156/78/39 at 96 rows
and the full-width 1248/624/312/156 at 24, 9 taps; a 512-wide level at
64 and levels 400 and 200 wide at 100): the lookup as the tree's
wrapper runs it and, where the tree has them, each of its forms forced
(``alt_lookup._taps_kernel``; the tiled form only where its dots fit),
with the largest difference between the two forms' outputs.
"""

from __future__ import annotations

import argparse
import hashlib
import math
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, LEVELS, K = 256, 4, 9
# (label, batch, height, width, fmap dtype, output dtype, with row 4)
SHAPES = (("op_serve", 1, 144, 240, "float32", "float32", False),
          ("op_train", 6, 80, 180, "float32", "float32", True),
          ("op_serve_bf16", 1, 144, 240, "bfloat16", "bfloat16", False))
LIBS = ("alt_corr_taps", "alt_corr_taps_bwd")
# (label, rows, W1, level widths, taps a level) for --forms
FORM_SHAPES = (("pyr_k36", 144, 240, (240, 120, 60, 30), 36),
               ("pyr_k72", 144, 240, (240, 120, 60, 30), 72),
               ("pyr_k144", 144, 240, (240, 120, 60, 30), 144),
               ("wide1000_k100", 144, 240, (1000,), 100),
               ("wide600_300_k150", 144, 240, (600, 300), 150),
               ("wide2000_k40", 144, 240, (2000,), 40),
               ("w100_50_k300", 144, 240, (100, 50), 300),
               ("eval_k9", 96, 312, (312, 156, 78, 39), 9),
               ("full1248_k9", 24, 1248, (1248, 624, 312, 156), 9),
               ("w512_k64", 144, 240, (512,), 64),
               ("w400_k100", 144, 240, (400, 200), 100))


def digest(*ts) -> str:
    import torch

    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def taps(kind, rows, h, w1, widths, g, torch):
    """(rows, W1, L*K) fp32 per-level local taps of one pattern."""
    xx = torch.arange(w1, dtype=torch.float32)
    yy = torch.arange(rows, dtype=torch.float32).reshape(rows, 1, 1) % h
    cols = []
    for w in widths:
        u = torch.rand((rows, w1, K), generator=g)
        if kind == "random":
            t = u * (w + 6) - 3
            centre = torch.rand((rows, w1, 1), generator=g) * (w + 3) - 2
        else:
            disp = 30.0 + 30.0 * torch.sin(2 * math.pi * (xx / 97.0
                                                          + yy / 13.0))
            centre = ((xx - disp) * (w / w1)).reshape(rows, w1, 1)
            t = centre + u * 8 - 4
        t[..., :5] = centre + torch.arange(-2.0, 3.0)
        t[..., 7] = torch.floor(t[..., 7])
        cols.append(t)
    out = torch.cat(cols, dim=-1)
    out[0, 0, K - 1] = 1e6
    out[-1, -1, 2] = float("nan")
    return out.contiguous()


def random_taps(rows, w1, widths, k, g, torch):
    """(rows, W1, L*K) uniform taps in [-3, w + 3] a level, one far tap
    and one NaN."""
    cols = [torch.rand((rows, w1, k), generator=g) * (w + 6) - 3
            for w in widths]
    out = torch.cat(cols, dim=-1)
    out[0, 0, k - 1] = 1e6
    out[-1, -1, 2] = float("nan")
    return out.contiguous()


def forms(alt_lookup, time_ms, torch) -> list:
    """Row 3 at FORM_SHAPES: the wrapper, and each form forced where
    the tree has them."""
    dev = torch.device("cuda")
    out = []
    for label, rows, w1, widths, k in FORM_SHAPES:
        g = torch.Generator().manual_seed(1)
        f1 = torch.randn((rows, w1, C), generator=g).to(dev)
        f2 = torch.randn((rows, sum(widths), C), generator=g).to(dev)
        t = random_taps(rows, w1, widths, k, g, torch).to(dev)
        ms = time_ms(lambda: alt_lookup.alt_corr_taps(f1, f2, t, widths), 10)
        line = f"forms {label} wrapper ms {ms:.4f}"
        if hasattr(alt_lookup, "_taps_kernel"):
            line += f" ({alt_lookup.alt_corr_taps_form(w1, widths, k)})"
            got = {}
            for form in ("tiled", "general"):
                if (form == "tiled" and alt_lookup.alt_corr_taps_form(
                        w1, widths, k) != "tiled"):
                    continue

                def kern(form=form):
                    return alt_lookup._taps_kernel(f1, f2, t, widths,
                                                   torch.float32, form)

                got[form] = kern()
                line += f" {form} ms {time_ms(kern, 10):.4f}"
            if len(got) == 2:
                diff = (got["tiled"] - got["general"]).nan_to_num()
                line += f" max |tiled - general| {float(diff.abs().max()):.3e}"
        out.append(line)
        del f1, f2, t
        torch.cuda.empty_cache()
    return out


def same_bits(a, b, torch) -> bool:
    """Equal NaN positions and equal bits elsewhere."""
    a, b = a.float(), b.float()
    ok = ~a.isnan()
    return (torch.equal(ok, ~b.isnan())
            and torch.equal(a[ok].view(torch.int32), b[ok].view(torch.int32)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--forms", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import torch

    import chip_smoke
    from raftstereo_tpu_torch.device import fp32_numerics
    from raftstereo_tpu_torch.ops import _build, alt_lookup
    from raftstereo_tpu_torch.ops.corr import build_corr_state

    if not alt_lookup.__file__.startswith(root):
        raise RuntimeError(f"{alt_lookup.__file__} is not under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    fp32_numerics()
    libs = _build.build_all()
    if args.report:
        for name in (n for n in LIBS if n in libs):
            log = libs[name].with_suffix(".log").read_text()
            for line in log.splitlines():
                if ("Function properties" in line or "registers" in line
                        or "spill" in line):
                    print(f"  {name}: {line.strip()}")
    if args.forms:
        print(f"{root} [{torch.cuda.get_device_name(0)}] "
              + " | ".join(forms(alt_lookup, chip_smoke.time_ms, torch)),
              flush=True)
        return 0
    dev = torch.device("cuda")
    out = []
    for label, b, h, w, dt, odt, with_bwd in SHAPES:
        g = torch.Generator().manual_seed(0)
        dtype, out_dtype = getattr(torch, dt), getattr(torch, odt)
        st = build_corr_state(torch.randn((b, h, w, C), generator=g).to(dev),
                              torch.randn((b, h, w, C), generator=g).to(dev),
                              LEVELS, corr_dtype=dtype)
        f1 = st.fmap1.reshape(b * h, w, C)
        f2 = st.f2cat.reshape(b * h, -1, C)
        for kind in ("random", "smooth"):
            t = taps(kind, b * h, h, w, st.widths, g, torch).to(dev)
            if "alt_corr_taps" in libs:
                def kern():
                    return alt_lookup.alt_corr_taps(f1, f2, t, st.widths,
                                                    out_dtype)

                k1, k2 = kern(), kern()
                torch.cuda.synchronize()
                ms = chip_smoke.time_ms(kern, 50)
                out.append(f"alt_corr_taps {label} {kind} ms {ms:.4f} "
                           f"repeat {same_bits(k1, k2, torch)} "
                           f"sha {digest(k1)}")
            if with_bwd and "alt_corr_taps_bwd" in libs:
                gout = torch.randn(t.shape, generator=g).to(dev)

                def bwd():
                    return alt_lookup.alt_corr_taps_backward(f1, f2, t, gout,
                                                             st.widths)

                d1, d2 = bwd(), bwd()
                torch.cuda.synchronize()
                ok = all(same_bits(x, y, torch) for x, y in zip(d1, d2))
                ms = chip_smoke.time_ms(bwd, 20)
                out.append(f"alt_corr_taps_bwd {label} {kind} ms {ms:.4f} "
                           f"repeat {ok} sha {digest(*d1)}")
        del st, f1, f2
        torch.cuda.empty_cache()
    print(f"{root} [{torch.cuda.get_device_name(0)}] " + " | ".join(out),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
