"""Rows 13, 12, 9, 15 and 16 (the fused encoder's convs: the 7x7 stems
``stem_conv7`` and ``stem_conv7_s2``, the 3x3 ``stage_conv``, ``l2_entry``
and ``l2_conv``) of one checkout of the PyTorch port, on the card, for
A/B comparisons of two trees in one call:

    python3 scripts/ab_enc_conv.py ROOT [--report] [--profile] [--stems]

ROOT is a checkout (or ``git archive``) holding ``raftstereo_tpu_torch``;
its kernels build under ROOT.  Prints one line per tree: each row's
CUDA-event time (``chip_smoke.time_ms``, from this script's checkout) at
the fused serving shapes (row 13: fnet's 2x3x576x960 image with sums,
cnet's 1 image without; row 12 at the same input with sums, the
``n_downsample=3`` stem; each beside one ``F.conv2d`` of the same input
and weights, and with a SHA-256 digest of its outputs; then fnet
2x64x576x960 with sums, cnet 1 image without; the residual form of row 9
with sums; row 16 at layer2's 2x96x288x480, its res_proj form too) and
the fused training shapes (fnet 12x64x320x720 with sums, cnet 6 images
without; row 16 at 12x96x160x360, both forms), each with its largest
error against the plain version, relative to max(1, |plain|) (sums per
pixel, as ``chip_smoke.hold``) and a SHA-256 digest of its outputs, and
beside row 16 one ``F.conv2d`` of the same input and weights; then rows
10, 11 and 17 (``plane_stats``, ``stage_finish``, ``l2_finish``) at the
same shapes, with their digests.  ``--report`` prints the ptxas report
(registers, shared memory, spills) of the encoder conv libraries first,
``--profile`` each call's kernels by device time, ``--stems`` times the
stems alone (a tree whose ``csrc`` holds only ``enc_conv.cu``: a stem
form being tried).  Run parent, change, change, parent in one call and
compare within it.

    python3 scripts/ab_enc_conv.py ROOT --bf16 [--report]

times the bf16 forms instead: rows 9, 15 and 16 in every form (row 9's
prep form with sums, without them on cnet's half batch, and its residual
form; row 15's conv and projection; row 16's prep and res_proj forms,
each with and without sums at the same batch), at the fused serving
shapes (2x64x576x960; layer2 2x96x288x480) and the fused training shapes
(12x64x320x720; 12x96x160x360), each with its largest difference from
its bf16 plain version in bf16 ulps of max(1, |plain|), the share of
equal elements and a SHA-256 digest of its outputs, beside one
``F.conv2d`` on bf16 tensors (cuDNN) of the same conv.
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


def _leaves(out):
    if out is None:
        return []
    if hasattr(out, "shape"):
        return [out]
    return [t for o in out for t in _leaves(o)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--stems", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from raftstereo_tpu_torch.device import fp32_numerics
    from raftstereo_tpu_torch.ops import _build
    from raftstereo_tpu_torch.ops import cuda_encoder as ce

    if not ce.__file__.startswith(root):
        raise RuntimeError(f"{ce.__file__} is not under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    fp32_numerics()  # the plain versions' cuDNN convs in fp32, not TF32
    libs = _build.build_all()
    if args.report:
        for name in ("enc_conv_tc", "enc_conv", "enc_conv_wg"):
            if name not in libs:
                continue
            log = libs[name].with_suffix(".log").read_text()
            for line in log.splitlines():
                if ("Function properties" in line or "registers" in line
                        or "spill" in line):
                    print(f"  {name}: {line.strip()}")
    if args.bf16:
        return bf16_main(root, torch, chip_smoke, ce, F)
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).to(dev)

    def aff(b, c):  # shifts > 0: padding before the prep would show
        return ((0.5 + torch.rand((b, c), generator=g)).to(dev),
                (0.5 * torch.rand((b, c), generator=g)).to(dev))

    wc, bc = randn(64, 64, 3, 3, scale=(2 / 576) ** 0.5), randn(64, scale=0.1)
    we, be = randn(96, 64, 3, 3, scale=(2 / 576) ** 0.5), randn(96, scale=0.1)
    wp, bp = randn(96, 64, 1, 1, scale=(2 / 64) ** 0.5), randn(96, scale=0.1)
    wl, bl = randn(96, 96, 3, 3, scale=(2 / 864) ** 0.5), randn(96, scale=0.1)
    out = []
    import hashlib

    def sha(outs):
        hs = hashlib.sha256()
        for t in outs:
            hs.update(t.detach().cpu().contiguous().numpy().tobytes())
        return hs.hexdigest()[:16]

    # -- the stems (rows 13 and 12) at the fused serving input
    img = torch.tanh(randn(2, 3, 576, 960))
    img1 = img[:1].contiguous()
    w1, b1 = randn(64, 3, 7, 7, scale=(2 / 147) ** 0.5), randn(64, scale=0.1)
    for label, npix, kern, plain, lib in (
            ("row13 2x3x576x960", 576.0 * 960,
             lambda: ce.stem_conv7(img, w1, b1),
             lambda: ce.conv_plain(img, w1, b1, 1),
             lambda: F.conv2d(img, w1, b1, 1, 3)),
            ("row13 1x3 no sums", 576.0 * 960,
             lambda: ce.stem_conv7(img1, w1, b1, want_stats=False),
             lambda: ce.conv_plain(img1, w1, b1, 1, want_stats=False),
             lambda: F.conv2d(img1, w1, b1, 1, 3)),
            ("row12 2x3x576x960", 288.0 * 480,
             lambda: ce.stem_conv7_s2(img, w1, b1),
             lambda: ce.conv_plain(img, w1, b1, 2),
             lambda: F.conv2d(img, w1, b1, 2, 3))):
        got, got2, want = _leaves(kern()), _leaves(kern()), _leaves(plain())
        torch.cuda.synchronize()
        err = 0.0
        for k, p in zip(got, want):
            if k.dim() == 2:
                k, p = k / npix, p / npix
            err = max(err, float((k - p).abs().max())
                      / max(1.0, float(p.abs().max())))
        same = all(torch.equal(a, c) for a, c in zip(got, got2))
        ms = chip_smoke.time_ms(kern, 10)
        lib_ms = chip_smoke.time_ms(lib, 10)
        out.append(f"{label} ms {ms:.4f} err {err:.2e} repeatable {same} "
                   f"sha {sha(got)} F.conv2d ms {lib_ms:.4f}")
        del got, got2, want
    del img, img1
    torch.cuda.empty_cache()
    paths = (("serve", 2, (576, 960)), ("train", 12, (320, 720)))
    for path, b, (h, w) in () if args.stems else paths:
        x, r = randn(b, 64, h, w), randn(b, 64, h, w)
        a, ra = aff(b, 64), aff(b, 64)
        t = torch.relu(x)
        half = b // 2
        x1, t1 = x[:half].contiguous(), t[:half].contiguous()
        a1 = (a[0][:half].contiguous(), a[1][:half].contiguous())
        n, n2 = float(h * w), float(((h - 1) // 2 + 1) * ((w - 1) // 2 + 1))
        cases = [
            (f"row9 {b}x64x{h}x{w}", n,
             lambda: ce.stage_conv(x, a, wc, bc),
             lambda: ce.conv_plain(x, wc, bc, 1, a)),
            (f"row9 {half}x64 no sums", n,
             lambda: ce.stage_conv(x1, a1, wc, bc, want_stats=False),
             lambda: ce.conv_plain(x1, wc, bc, 1, a1, want_stats=False)),
            (f"row15 {b}x64x{h}x{w}", n2,
             lambda: ce.l2_entry(t, we, be, wp, bp),
             lambda: ce.entry_plain(t, we, be, wp, bp)),
            (f"row15 {half}x64 no sums", n2,
             lambda: ce.l2_entry(t1, we, be, wp, bp, want_stats=False),
             lambda: ce.entry_plain(t1, we, be, wp, bp, want_stats=False))]
        if path == "serve":
            cases.append((f"row9 res {b}x64", n,
                          lambda: ce.stage_conv(x, a, wc, bc, res=r,
                                                res_aff=ra),
                          lambda: ce.conv_plain(x, wc, bc, 1, a, r, ra)))
        h2, w2 = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        y, yp = randn(b, 96, h2, w2), randn(b, 96, h2, w2)
        ay, ayp = aff(b, 96), aff(b, 96)
        y1 = y[:half].contiguous()
        ay1 = (ay[0][:half].contiguous(), ay[1][:half].contiguous())
        cases += [
            (f"row16 {b}x96x{h2}x{w2}", n2,
             lambda: ce.l2_conv(y, ay, wl, bl),
             lambda: ce.conv_plain(y, wl, bl, 1, ay)),
            (f"row16 {half}x96 no sums", n2,
             lambda: ce.l2_conv(y1, ay1, wl, bl, want_stats=False),
             lambda: ce.conv_plain(y1, wl, bl, 1, ay1, want_stats=False)),
            (f"row16 res {b}x96", n2,
             lambda: ce.l2_conv(y, ay, wl, bl, res=yp, res_aff=ayp),
             lambda: ce.conv_plain(y, wl, bl, 1, ay, yp, ayp,
                                   res_relu=False))]
        q = randn(b, 96, h2, w2)
        a3, ayq = aff(b, 64), aff(b, 96)
        cases += [
            (f"row10 {b}x64x{h}x{w}", n, lambda: ce.plane_stats(x),
             lambda: ce.stats_plain(x)),
            (f"row11 {b}x64x{h}x{w}", 1.0,
             lambda: ce.stage_finish(x, a, r, ra, t, a3),
             lambda: ce.finish_plain(x, a, r, ra, t, a3)),
            (f"row17 {b}x96x{h2}x{w2}", 1.0,
             lambda: ce.l2_finish(yp, ayp, y, ay, q, ayq),
             lambda: ce.finish_plain(yp, ayp, y, ay, q, ayq, a_relu=False))]
        for label, npix, kern, plain in cases:
            got, want = _leaves(kern()), _leaves(plain())
            torch.cuda.synchronize()
            err = 0.0
            for k, p in zip(got, want):
                if k.dim() == 2:
                    k, p = k / npix, p / npix
                err = max(err, float((k - p).abs().max())
                          / max(1.0, float(p.abs().max())))
            ms = chip_smoke.time_ms(kern, 5)
            out.append(f"{label} ms {ms:.4f} err {err:.2e} sha {sha(got)}")
            if label.startswith(f"row16 {b}x"):
                lib = chip_smoke.time_ms(lambda: F.conv2d(y, wl, bl, 1, 1), 5)
                out.append(f"row16 F.conv2d ms {lib:.4f}")
            if args.profile:
                cuda = torch.profiler.ProfilerActivity.CUDA
                with torch.profiler.profile(activities=[cuda]) as prof:
                    kern()
                    torch.cuda.synchronize()
                print(f"  {label}: " + "; ".join(
                    f"{_short(ev.name)} {ev.device_time_total / 1e3:.3f}"
                    for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA))
        del x, r, t, x1, t1, y, yp, y1, q
        torch.cuda.empty_cache()
    print(f"{root} [{torch.cuda.get_device_name(0)}] " + " | ".join(out),
          flush=True)
    return 0


def bf16_main(root, torch, chip_smoke, ce, F) -> int:
    """``--bf16``: rows 9, 15 and 16's bf16 forms at the fused serving
    and training shapes, one line per tree."""
    import hashlib

    bf = torch.bfloat16
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).to(dev)

    def aff(b, c):  # shifts > 0: padding before the prep would show
        return ((0.5 + torch.rand((b, c), generator=g)).to(dev),
                (0.5 * torch.rand((b, c), generator=g)).to(dev))

    def sha(outs):
        hs = hashlib.sha256()
        for t in outs:
            hs.update(t.detach().cpu().contiguous().view(torch.uint8)
                      .numpy().tobytes())
        return hs.hexdigest()[:16]

    wc, bc = randn(64, 64, 3, 3, scale=(2 / 576) ** 0.5), randn(64, scale=0.1)
    we, be = randn(96, 64, 3, 3, scale=(2 / 576) ** 0.5), randn(96, scale=0.1)
    wp, bp = randn(96, 64, 1, 1, scale=(2 / 64) ** 0.5), randn(96, scale=0.1)
    wl, bl = randn(96, 96, 3, 3, scale=(2 / 864) ** 0.5), randn(96, scale=0.1)
    out = []
    for path, b, (h, w) in (("serve", 2, (576, 960)),
                            ("train", 12, (320, 720))):
        x = (randn(b, 64, h, w) * 2 + 0.3).to(bf)
        a = aff(b, 64)
        t = torch.relu(randn(b, 64, h, w)).to(bf)
        h2, w2 = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        y = (randn(b, 96, h2, w2) * 2 + 0.3).to(bf)
        p = (randn(b, 96, h2, w2) * 2 - 0.3).to(bf)
        ay, ap = aff(b, 96), aff(b, 96)
        r = (randn(b, 64, h, w) * 2 - 0.3).to(bf)
        ra = aff(b, 64)
        half = b // 2
        x1 = x[:half].contiguous()
        a1 = (a[0][:half].contiguous(), a[1][:half].contiguous())
        n, n2 = float(h * w), float(h2 * w2)
        cases = [(f"row9 {b}x64x{h}x{w}", n,
                  lambda: ce.stage_conv(x, a, wc, bc),
                  lambda: ce.conv_plain(x, wc, bc, 1, a),
                  lambda: F.conv2d(x, wc.to(bf), bc.to(bf), 1, 1)),
                 (f"row9 {half}x64x{h}x{w} no sums", n,
                  lambda: ce.stage_conv(x1, a1, wc, bc, want_stats=False),
                  lambda: ce.conv_plain(x1, wc, bc, 1, a1,
                                        want_stats=False),
                  lambda: F.conv2d(x1, wc.to(bf), bc.to(bf), 1, 1)),
                 (f"row9 res {b}x64x{h}x{w}", n,
                  lambda: ce.stage_conv(x, a, wc, bc, res=r, res_aff=ra),
                  lambda: ce.conv_plain(x, wc, bc, 1, a, r, ra), None)]
        for ws in (True, False):
            tag = "" if ws else " no sums"
            cases += [
                (f"row15 {b}x64x{h}x{w}{tag}", n2,
                 lambda ws=ws: ce.l2_entry(t, we, be, wp, bp, want_stats=ws),
                 lambda ws=ws: ce.entry_plain(t, we, be, wp, bp, ws),
                 lambda: F.conv2d(t, we.to(bf), be.to(bf), 2, 1)),
                (f"row16 {b}x96x{h2}x{w2}{tag}", n2,
                 lambda ws=ws: ce.l2_conv(y, ay, wl, bl, want_stats=ws),
                 lambda ws=ws: ce.conv_plain(y, wl, bl, 1, ay,
                                             want_stats=ws),
                 lambda: F.conv2d(y, wl.to(bf), bl.to(bf), 1, 1)),
                (f"row16 res {b}x96x{h2}x{w2}{tag}", n2,
                 lambda ws=ws: ce.l2_conv(y, ay, wl, bl, res=p, res_aff=ap,
                                          want_stats=ws),
                 lambda ws=ws: ce.conv_plain(y, wl, bl, 1, ay, p, ap,
                                             res_relu=False, want_stats=ws),
                 None)]
        for label, npix, kern, plain, lib in cases:
            got, want = _leaves(kern()), _leaves(plain())
            torch.cuda.synchronize()
            ulps, eq, err = 0.0, 1.0, 0.0
            for k, q in zip(got, want):
                if k.dtype == bf:
                    k, q = k.float(), q.float()
                    ulps = max(ulps, float(((k - q).abs() / q.abs()
                                            .clamp_min(1.0)).max()) * 128)
                    eq = min(eq, float((k == q).float().mean()))
                else:
                    err = max(err, float(((k - q) / npix).abs().max())
                              / max(1.0, float((q / npix).abs().max())))
            ms = chip_smoke.time_ms(kern, 5)
            line = (f"{label} ms {ms:.4f} ulps {ulps:.2f} equal {eq:.5f} "
                    f"sums {err:.2e} sha {sha(got)}")
            if lib is not None:
                line += f" F.conv2d ms {chip_smoke.time_ms(lib, 5):.4f}"
            out.append(line)
            del got, want
        del x, t, y, p, r, x1
        torch.cuda.empty_cache()
    print(f"{root} [{torch.cuda.get_device_name(0)}] " + " | ".join(out),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
