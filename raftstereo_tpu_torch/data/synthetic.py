"""Synthetic stereo data made from a seed: the in-memory
``ShiftStereoDataset`` and KITTI-layout trees for the dataset readers.

Copies of the JAX package's ``data/synthetic.py`` builders, so that
training and the readers run on hosts with no real data.
"""

from __future__ import annotations

import os
from os.path import join

import numpy as np
from PIL import Image

from .png16 import write_png16

__all__ = ["ShiftStereoDataset", "make_synthetic_kitti", "make_learnable_kitti"]


class ShiftStereoDataset:
    """In-memory, *learnable* stereo pairs: a smooth random texture and its
    horizontally shifted copy, ground-truth disparity = the shift.

    Matched texture makes the correlation volume genuinely informative, so a
    model can drive EPE toward zero by learning — unlike the independent
    random images in the tree builders above, which have no learnable
    structure.  Used by the convergence demonstration
    (scripts/overfit_demo.py, tests/test_convergence.py): overfitting this
    set proves the whole training pipeline (loss, optimizer, schedule,
    gradients) *learns*, not just runs.

    Items use the data-layer protocol: (meta, img1, img2, flow(H,W,1), valid).
    """

    def __init__(self, n=16, hw=(64, 96), max_disp=8.0, seed=0):
        h, w = hw
        rng = np.random.default_rng(seed)
        self._items = []
        for i in range(n):
            d = float(rng.uniform(2.0, max_disp))
            di = int(round(d))
            # Smooth texture (random low-res upsampled) so matching is
            # locally unambiguous at integer-pixel precision.
            low = rng.uniform(0, 255, (h // 4 + 1, (w + di) // 4 + 2, 3))
            tex = np.kron(low, np.ones((4, 4, 1)))[:h, :w + di]
            # left(x) matches right(x - d): right(y) = left(y + d).
            img1 = tex[:, :w].astype(np.float32)          # left
            img2 = tex[:, di:di + w].astype(np.float32)   # right
            flow = np.full((h, w, 1), -float(di), np.float32)
            valid = np.ones((h, w), np.float32)
            self._items.append((["synthetic", i], img1, img2, flow, valid))

    def reseed(self, seed):  # loader protocol; the set is static
        pass

    def __len__(self):
        return len(self._items)

    def __getitem__(self, i):
        return self._items[i % len(self._items)]



def make_synthetic_kitti(root, n=6, hw=(120, 160), rng=None):
    """KITTI-2015 training split: image_2/image_3 pairs + 16-bit disp_occ_0
    (reference: core/stereo_datasets.py:246-257)."""
    rng = rng or np.random.default_rng(0)
    root = str(root)
    h, w = hw
    os.makedirs(join(root, "training", "image_2"))
    os.makedirs(join(root, "training", "image_3"))
    os.makedirs(join(root, "training", "disp_occ_0"))
    for i in range(n):
        for cam in ("image_2", "image_3"):
            img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            Image.fromarray(img).save(
                join(root, "training", cam, f"{i:06d}_10.png"))
        disp = (rng.uniform(1, 60, (h, w)) * 256).astype(np.uint16)
        write_png16(join(root, "training", "disp_occ_0", f"{i:06d}_10.png"),
                    disp)



def make_learnable_kitti(root, n=48, hw=(352, 744), max_disp=24, rng=None):
    """KITTI-2015-layout tree whose pairs are actually LEARNABLE: smooth
    textures with a constant integer shift per image, ground truth = the
    shift (the on-disk twin of :class:`ShiftStereoDataset`, same
    ``right(y) = left(y + d)`` convention).

    The plain :func:`make_synthetic_kitti` writes independent random images
    — fine for layout/reader tests, useless for a training run whose loss
    curve should decrease.  Training on this tree through the KITTI reader
    and the sparse augmentor drives EPE toward zero.
    """
    rng = rng or np.random.default_rng(0)
    root = str(root)
    h, w = hw
    os.makedirs(join(root, "training", "image_2"))
    os.makedirs(join(root, "training", "image_3"))
    os.makedirs(join(root, "training", "disp_occ_0"))
    for i in range(n):
        d = int(rng.integers(4, max_disp + 1))
        low = rng.uniform(0, 255, (h // 4 + 1, (w + d) // 4 + 2, 3))
        tex = np.kron(low, np.ones((4, 4, 1)))[:h, :w + d]
        left = tex[:, :w].astype(np.uint8)
        right = tex[:, d:d + w].astype(np.uint8)
        Image.fromarray(left).save(
            join(root, "training", "image_2", f"{i:06d}_10.png"))
        Image.fromarray(right).save(
            join(root, "training", "image_3", f"{i:06d}_10.png"))
        disp = np.full((h, w), d * 256, np.uint16)  # KITTI 16-bit: px * 256
        write_png16(join(root, "training", "disp_occ_0", f"{i:06d}_10.png"),
                    disp)
