"""Rows 5 and 7 of one checkout of the PyTorch port, on the card, for A/B
comparisons of two trees in one call:

    python3 scripts/ab_volume.py ROOT [--report]

ROOT is a checkout (or ``git archive``) holding ``raftstereo_tpu_torch``;
its kernels build under ROOT.  Prints one line per tree with the
CUDA-event time (``chip_smoke.time_ms``, ROOT's where ROOT has a
``chip_smoke.py``, else this script's checkout's) of:

- row 5, the precomputed-volume lookup (``vol_lookup``), at the serving
  pyramid (1x144x240, level widths 240/120/60/30) and the training one
  (6x80x180, 180/90/45/22), 4 levels of radius 4, on the smoke's random
  disparity field (x = column - 60 U(0, 1)) and on a smooth one (a
  low-frequency sine of x and y in [-60, 0]);
- row 7, the int8 volume (``int8_corr_volume``), at the serving shape
  (1x144x240 features, C = 256, rows quantized by ``quantize_rows``),
  and the whole ``corr_quant`` state as a request builds it
  (``build_corr_state``: quantization, the volume, its pyramid pooled
  from it and concatenated), which reads the volume back after the
  kernel writes it;
- where the tree has them, the bf16 forms: row 5 over the bf16 volume
  pyramid (``build_corr_state(..., corr_dtype=bfloat16)``) at both shapes
  on both fields, and row 7 writing a bf16 volume at the serving shape.

Each with whether it is bitwise equal to its plain version and to a
second call, and a SHA-256 digest of its output: equal digests from two
trees mean bitwise equal outputs.  The inputs come from this script's
seeded generators (one a row), so both trees see the same ones.  ``--report`` prints
the ptxas report (registers, shared memory, spills) of the two libraries
first.  A tree whose ``csrc`` holds only one of the two sources (a form
being tried) times only its row.  Run parent, change, change, parent in
one call and compare within it.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import math
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, LEVELS, RADIUS = 256, 4, 4
SHAPES = (("serve", 1, 144, 240), ("train", 6, 80, 180))
LIBS = ("corr_vol", "int8_volume")


def digest(t) -> str:
    import torch

    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()[:16]


def field(kind, b, h, w, g, torch):
    """x (b, h, w): column minus a disparity in [-60, 0], random per pixel
    or a low-frequency sine of x and y."""
    xx = torch.arange(w, dtype=torch.float32)
    if kind == "random":
        return xx - 60.0 * torch.rand((b, h, w), generator=g)
    yy = torch.arange(b * h, dtype=torch.float32).reshape(b, h, 1)
    return xx - 30.0 + 30.0 * torch.sin(2 * math.pi * (xx / 97.0
                                                         + yy / 13.0))


def same_bits(a, b, torch) -> bool:
    """Equal NaN positions and equal bits elsewhere."""
    ok = ~a.isnan()
    return (torch.equal(ok, ~b.isnan())
            and torch.equal(a[ok].view(torch.int32), b[ok].view(torch.int32)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--report", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import torch

    import chip_smoke
    from raftstereo_tpu_torch.device import fp32_numerics
    from raftstereo_tpu_torch.ops import _build, cuda_vol, quant
    from raftstereo_tpu_torch.ops.corr import build_corr_state

    if not cuda_vol.__file__.startswith(root):
        raise RuntimeError(f"{cuda_vol.__file__} is not under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    fp32_numerics()  # the plain versions' matmuls in fp32, not TF32
    libs = _build.build_all()
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
    # the bf16 forms, where the tree has them (its wrapper takes out_dtype)
    bf16 = "out_dtype" in inspect.signature(quant.int8_corr_volume).parameters
    dtypes = (torch.float32, torch.bfloat16) if bf16 else (torch.float32,)
    for label, b, h, w, dt in ((*sh, dt) for dt in dtypes for sh in SHAPES
                               if "corr_vol" in libs):
        st = build_corr_state(torch.randn((b, h, w, C), generator=g).to(dev),
                              torch.randn((b, h, w, C), generator=g).to(dev),
                              LEVELS, "pallas", corr_dtype=dt)
        if dt == torch.bfloat16:
            label += " bf16"
        for kind in ("random", "smooth"):
            x = field(kind, b, h, w, g, torch).to(dev).contiguous()

            def kern():
                return cuda_vol.vol_lookup(st.vcat, st.widths, x, RADIUS)

            k1, k2 = kern(), kern()
            want = cuda_vol.vol_lookup_plain(st.vcat, st.widths, x, RADIUS)
            torch.cuda.synchronize()
            ok = same_bits(k1, want, torch) and same_bits(k1, k2, torch)
            ms = chip_smoke.time_ms(kern, 50)
            out.append(f"vol_lookup {label} {kind} {b}x{h}x{w} ms {ms:.4f} "
                       f"bitwise {ok} sha {digest(k1)}")
            del x, k1, k2, want
        del st
        torch.cuda.empty_cache()

    if "int8_volume" not in libs:
        print(f"{root} [{torch.cuda.get_device_name(0)}] " + " | ".join(out),
              flush=True)
        return 0
    g = torch.Generator().manual_seed(1)  # row 7's own inputs
    _, b, h, w = SHAPES[0]
    f1, f2 = (torch.randn((b, h, w, C), generator=g).to(dev)
              for _ in "12")
    q1, s1 = quant.quantize_rows(f1)
    q2, s2 = quant.quantize_rows(f2)

    def vol():
        return quant.int8_corr_volume(q1, s1, q2, s2)

    k1, k2 = vol(), vol()
    want = quant.int8_volume_plain(q1, s1, q2, s2)
    torch.cuda.synchronize()
    ok = same_bits(k1, want, torch) and same_bits(k1, k2, torch)
    ms = chip_smoke.time_ms(vol, 50)
    out.append(f"int8_volume serve {b}x{h}x{w}x{w} C{C} ms {ms:.4f} "
               f"bitwise {ok} sha {digest(k1)}")
    del k1, k2, want
    if bf16:
        bf = torch.bfloat16

        def vol16():
            return quant.int8_corr_volume(q1, s1, q2, s2, out_dtype=bf)

        k1, k2 = vol16(), vol16()
        want = quant.int8_volume_plain(q1, s1, q2, s2, out_dtype=bf)
        torch.cuda.synchronize()
        ok = (torch.equal(k1.view(torch.int16), want.view(torch.int16))
              and torch.equal(k1.view(torch.int16), k2.view(torch.int16)))
        ms = chip_smoke.time_ms(vol16, 50)
        out.append(f"int8_volume bf16 serve ms {ms:.4f} bitwise {ok} sha "
                   f"{digest(k1)}")
        del k1, k2, want

    def quant_state():  # the volume as a request builds it: then pooled
        return build_corr_state(f1, f2, LEVELS, "pallas", quant=True)

    out.append(f"corr_quant state serve ms "
               f"{chip_smoke.time_ms(quant_state, 20):.4f}")
    print(f"{root} [{torch.cuda.get_device_name(0)}] " + " | ".join(out),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
