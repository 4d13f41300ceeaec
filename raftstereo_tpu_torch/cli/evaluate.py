"""Evaluate the port on a stereo benchmark.

    python -m raftstereo_tpu_torch.cli.evaluate --dataset kitti \
        --restore_ckpt WEIGHTS [--dataset_root DIR] [--valid_iters 32] \
        [--device cuda] [model flags]

The twin of the JAX package's ``cli/evaluate.py``.  ``--restore_ckpt``
takes an upstream ``.pth``, the port's ``save_weights`` file or a
flattened JAX ``.npz`` (``cli.common.load_weights_any``); without it the
model has seeded random weights, with a warning.  Runs on the card
unless ``--device cpu``.  Prints the parameter count and one JSON line
with the benchmark's EPE / D1 (and ``kitti-fps``).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from ..eval import VALIDATORS, validate
from ..models import RAFTStereo
from .common import (add_model_args, load_weights_any,
                     model_config_from_args, setup_logging)

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--restore_ckpt", default=None,
                   help=".pth, save_weights file or flattened JAX .npz")
    p.add_argument("--dataset", required=True, choices=sorted(VALIDATORS),
                   help="benchmark to run")
    p.add_argument("--valid_iters", type=int, default=32,
                   help="GRU refinement iterations at eval time")
    p.add_argument("--dataset_root", default=None,
                   help="override the default datasets/ root")
    p.add_argument("--max_images", type=int, default=None,
                   help="evaluate only the first N images (things only)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a GPU) or 'cpu'")
    add_model_args(p)
    return p


def main(argv=None) -> int:
    setup_logging()
    args = build_parser().parse_args(argv)
    model = RAFTStereo(model_config_from_args(args), device=args.device)
    if args.restore_ckpt:
        fmt = load_weights_any(args.restore_ckpt, model)
        logger.info("Loaded checkpoint %s (%s)", args.restore_ckpt, fmt)
    else:
        logger.warning("No --restore_ckpt: evaluating RANDOM weights")
    logger.info("The model has %.2fM learnable parameters.",
                sum(p.numel() for p in model.parameters()) / 1e6)

    kwargs = {"iters": args.valid_iters}
    if args.dataset_root:
        kwargs["root"] = args.dataset_root
    if args.max_images is not None and args.dataset == "things":
        kwargs["max_images"] = args.max_images
    results = validate(args.dataset, model, **kwargs)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
