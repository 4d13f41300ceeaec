"""Certify the serving accuracy tiers: per-tier EPE deltas against fp32.

    python -m raftstereo_tpu_torch.cli.certify --tiers fast turbo \
        --out certification.json [--restore_ckpt WEIGHTS] [--device cuda] \
        [--cert_height 256 --cert_width 320 --cert_pairs 4 --cert_iters 16]
        [--bound fast=0.5 turbo=1.0] [model flags]

The twin of the JAX package's ``cli/certify.py`` (its tier verb): runs
``eval.certify.certify_tiers`` on synthetic pairs with exact ground truth
and writes the manifest that ``cli.serve --tiers ... --cert_manifest``
validates at startup before it advertises a tier.  The manifest records
the platform it was measured on (the card's name, or the CPU), and
certifies only there.  ``--restore_ckpt`` takes an upstream ``.pth``,
the port's ``save_weights`` file or a flattened JAX ``.npz``; without it
the model has seeded random weights (the manifest fingerprints the
architecture, not the weights).  Prints one JSON line and exits 1 when a
tier measures over its bound.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from ..models import RAFTStereo
from .common import (add_model_args, load_weights_any,
                     model_config_from_args, setup_logging)

logger = logging.getLogger(__name__)


def _parse_bound(text: str):
    try:
        tier, px = text.split("=")
        bound = float(px)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"bound {text!r} is not TIER=PX (e.g. fast=0.5)")
    if tier not in ("fast", "turbo"):
        raise argparse.ArgumentTypeError(
            f"bound tier {tier!r} is not certifiable (fast/turbo)")
    return tier, bound


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--restore_ckpt", default=None,
                   help=".pth, save_weights file or flattened JAX .npz")
    p.add_argument("--tiers", nargs="+", default=["fast", "turbo"],
                   choices=["fast", "turbo"], metavar="TIER",
                   help="tiers to measure ('certified' is the fp32 "
                        "reference itself and needs no certificate)")
    p.add_argument("--out", default="certification.json",
                   help="manifest path the server's --cert_manifest reads")
    p.add_argument("--cert_height", type=int, default=256)
    p.add_argument("--cert_width", type=int, default=320)
    p.add_argument("--cert_pairs", type=int, default=4,
                   help="synthetic pairs in the certification set")
    p.add_argument("--cert_iters", type=int, default=16,
                   help="GRU iterations per certification forward")
    p.add_argument("--cert_seed", type=int, default=0)
    p.add_argument("--bound", type=_parse_bound, nargs="+", default=[],
                   metavar="TIER=PX",
                   help="a tier's mean-EPE-delta bound in px (defaults: "
                        "eval.certify.DEFAULT_BOUNDS)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a GPU) or 'cpu'")
    add_model_args(p)
    return p


def main(argv=None) -> int:
    setup_logging()
    args = build_parser().parse_args(argv)
    from ..eval.certify import certify_tiers, write_manifest

    model = RAFTStereo(model_config_from_args(args), device=args.device)
    if args.restore_ckpt:
        fmt = load_weights_any(args.restore_ckpt, model)
        logger.info("Loaded checkpoint %s (%s)", args.restore_ckpt, fmt)
    else:
        logger.warning("No --restore_ckpt: certifying RANDOM weights")
    manifest = certify_tiers(
        model, tuple(args.tiers), hw=(args.cert_height, args.cert_width),
        n_pairs=args.cert_pairs, iters=args.cert_iters, seed=args.cert_seed,
        bounds=dict(args.bound) or None)
    write_manifest(manifest, args.out)
    summary = {tier: {k: e[k] for k in ("epe_delta", "bound", "certified")}
               for tier, e in manifest["tiers"].items()}
    print(json.dumps({"manifest": args.out, "platform": manifest["platform"],
                      "epe_ref": manifest["eval"]["epe_ref"],
                      "tiers": summary}), flush=True)
    over = [t for t, e in manifest["tiers"].items() if not e["certified"]]
    if over:
        logger.error("tiers over bound: %s", over)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
