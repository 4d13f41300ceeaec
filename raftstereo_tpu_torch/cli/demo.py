"""Infer disparities for image pairs and save visualisations.

    python -m raftstereo_tpu_torch.cli.demo --restore_ckpt WEIGHTS \
        -l "dir/*/im0.png" -r "dir/*/im1.png" --output_directory out \
        [--save_numpy] [--tiled --tile_size H W --tile_overlap N \
        --max_disparity D] [--device cuda] [model flags]

The twin of the JAX package's ``cli/demo.py``: jet-colormapped PNGs of
POSITIVE disparity (the model predicts negative x-flow) and optionally
the raw ``.npy`` fields.  Output names are the left images' basenames
when unique, else their parent directories' names (ETH3D names every
left image im0.png), else prefixed by the pair's index.  ``--tiled``
runs fixed-shape tiles blended on the host (``eval.tiled``).
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys

import numpy as np
from PIL import Image

from ..eval import Evaluator
from ..eval.tiled import tiled_infer
from ..models import RAFTStereo
from ..utils.viz import save_disparity_png
from .common import (add_model_args, load_weights_any,
                     model_config_from_args, setup_logging)

logger = logging.getLogger(__name__)


def load_image(path: str) -> np.ndarray:
    img = np.asarray(Image.open(path), np.uint8)
    if img.ndim == 2:
        img = np.tile(img[..., None], (1, 1, 3))
    return img[..., :3].astype(np.float32)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--restore_ckpt", required=True,
                   help=".pth, save_weights file or flattened JAX .npz")
    p.add_argument("-l", "--left_imgs", required=True,
                   help="glob for left (reference) images")
    p.add_argument("-r", "--right_imgs", required=True,
                   help="glob for right images")
    p.add_argument("--output_directory", default="demo_output")
    p.add_argument("--save_numpy", action="store_true",
                   help="also save raw disparity as .npy")
    p.add_argument("--valid_iters", type=int, default=32)
    p.add_argument("--tiled", action="store_true",
                   help="tile very large images: fixed-shape tiles, "
                        "feather-blended on the host")
    p.add_argument("--tile_size", type=int, nargs=2, default=(1056, 1568),
                   metavar=("H", "W"), help="tile shape for --tiled")
    p.add_argument("--tile_overlap", type=int, default=128)
    p.add_argument("--max_disparity", type=int, default=512,
                   help="--tiled only: untrusted left strip width per tile")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a GPU) or 'cpu'")
    add_model_args(p)
    return p


def output_stems(left):
    """Basenames when unique, else parent directory names, else indexed."""
    stems = [os.path.splitext(os.path.basename(p))[0] for p in left]
    if len(set(stems)) != len(stems):
        stems = [os.path.basename(os.path.dirname(p)) for p in left]
    if len(set(stems)) != len(stems):
        stems = [f"{i:06d}_{s}" for i, s in enumerate(stems)]
    return stems


def main(argv=None) -> int:
    setup_logging()
    args = build_parser().parse_args(argv)
    model = RAFTStereo(model_config_from_args(args), device=args.device)
    load_weights_any(args.restore_ckpt, model)
    run = Evaluator(model, iters=args.valid_iters)

    left = sorted(glob.glob(args.left_imgs, recursive=True))
    right = sorted(glob.glob(args.right_imgs, recursive=True))
    if not left or len(left) != len(right):
        logger.error("Bad globs: %d left vs %d right images",
                     len(left), len(right))
        return 1
    logger.info("Found %d image pairs. Saving files to %s/",
                len(left), args.output_directory)
    os.makedirs(args.output_directory, exist_ok=True)

    for imfile1, imfile2, stem in zip(left, right, output_stems(left)):
        if args.tiled:
            flow = tiled_infer(
                model, load_image(imfile1), load_image(imfile2),
                iters=args.valid_iters, tile_hw=tuple(args.tile_size),
                overlap=args.tile_overlap, disp_margin=args.max_disparity)
        else:
            flow = run(load_image(imfile1), load_image(imfile2))
        disparity = -flow  # positive disparity for output
        out = os.path.join(args.output_directory, stem)
        if args.save_numpy:
            np.save(f"{out}.npy", disparity)
        save_disparity_png(f"{out}.png", disparity)
        if args.tiled:
            logger.info("%s -> %s.png (tiled)", imfile1, out)
        else:
            logger.info("%s -> %s.png (%.3fs)", imfile1, out, run.last_runtime)
    return 0


if __name__ == "__main__":
    sys.exit(main())
