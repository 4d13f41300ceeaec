"""Dataset registry: map-style stereo datasets + mixing logic.

A copy of the JAX package's ``data/datasets.py`` (without the
structured-light datasets).  Capability mirror of the reference's dataset
layer (reference: core/stereo_datasets.py), numpy-only.  Samples are NHWC numpy:
``(meta, img1, img2, flow, valid)`` with flow = [-disparity] single-channel
(the stereo sign convention, reference: core/stereo_datasets.py:77,107).
Directory layouts match the reference so existing dataset trees drop in.
"""

from __future__ import annotations

import copy
import glob as globlib
import logging
import os
import os.path as osp
import re
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np

from . import codecs
from .augment import FlowAugmentor, SparseFlowAugmentor

logger = logging.getLogger(__name__)


class StereoDataset:
    """Base map-style dataset (reference: core/stereo_datasets.py:21-120)."""

    def __init__(self, aug_params: Optional[dict] = None, sparse: bool = False,
                 reader: Optional[Callable] = None):
        aug_params = dict(aug_params) if aug_params is not None else None
        self.augmentor = None
        self.sparse = sparse
        self.img_pad = (aug_params.pop("img_pad", None)
                        if aug_params is not None else None)
        if aug_params is not None and "crop_size" in aug_params:
            cls = SparseFlowAugmentor if sparse else FlowAugmentor
            self.augmentor = cls(**aug_params)
        self.disparity_reader = reader or codecs.read_gen
        self.is_test = False
        self.rng = np.random.default_rng(0)
        self.flow_list: List[str] = []
        self.disparity_list: List[str] = []
        self.image_list: List[List[str]] = []
        self.extra_info: List = []

    def reseed(self, seed: int) -> None:
        """Per-worker/per-epoch reseeding hook (the reference seeds torch
        worker processes instead: core/stereo_datasets.py:55-61)."""
        self.rng = np.random.default_rng(seed)

    def __getitem__(self, index: int):
        if self.is_test:
            img1 = np.asarray(codecs.read_gen(self.image_list[index][0]),
                              np.uint8)[..., :3]
            img2 = np.asarray(codecs.read_gen(self.image_list[index][1]),
                              np.uint8)[..., :3]
            return (img1.astype(np.float32), img2.astype(np.float32),
                    self.extra_info[index])

        index = index % len(self.image_list)
        disp = self.disparity_reader(self.disparity_list[index])
        if isinstance(disp, tuple):
            disp, valid = disp
        else:
            valid = disp < 512

        img1 = np.asarray(codecs.read_gen(self.image_list[index][0]), np.uint8)
        img2 = np.asarray(codecs.read_gen(self.image_list[index][1]), np.uint8)
        disp = np.asarray(disp, np.float32)
        flow = np.stack([-disp, np.zeros_like(disp)], axis=-1)

        if img1.ndim == 2:
            img1 = np.tile(img1[..., None], (1, 1, 3))
            img2 = np.tile(img2[..., None], (1, 1, 3))
        else:
            img1 = img1[..., :3]
            img2 = img2[..., :3]

        if self.augmentor is not None:
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(img1, img2, flow,
                                                         valid, self.rng)
            else:
                img1, img2, flow = self.augmentor(img1, img2, flow, self.rng)

        img1 = img1.astype(np.float32)
        img2 = img2.astype(np.float32)
        flow = flow.astype(np.float32)
        if self.sparse:
            valid = valid.astype(np.float32)
        else:
            valid = ((np.abs(flow[..., 0]) < 512)
                     & (np.abs(flow[..., 1]) < 512)).astype(np.float32)

        if self.img_pad is not None:
            pad_h, pad_w = self.img_pad
            pad = ((pad_h, pad_h), (pad_w, pad_w), (0, 0))
            img1 = np.pad(img1, pad)
            img2 = np.pad(img2, pad)

        meta = self.image_list[index] + [self.disparity_list[index]]
        return meta, img1, img2, flow[..., :1], valid

    def __mul__(self, v: int) -> "StereoDataset":
        out = copy.deepcopy(self)
        out.flow_list = v * out.flow_list
        out.image_list = v * out.image_list
        out.disparity_list = v * out.disparity_list
        out.extra_info = v * out.extra_info
        return out

    def __add__(self, other: "StereoDataset") -> "ConcatDataset":
        return ConcatDataset([self, other])

    def __len__(self) -> int:
        return len(self.image_list)


class ConcatDataset:
    """Dataset concatenation (torch's `+` equivalent)."""

    def __init__(self, parts: Sequence):
        self.parts = []
        for p in parts:
            if isinstance(p, ConcatDataset):
                self.parts.extend(p.parts)
            else:
                self.parts.append(p)

    def reseed(self, seed: int) -> None:
        for i, p in enumerate(self.parts):
            p.reseed(seed + i)

    def __add__(self, other):
        return ConcatDataset([self, other])

    def __len__(self):
        return sum(len(p) for p in self.parts)

    def __getitem__(self, index):
        for p in self.parts:
            if index < len(p):
                return p[index]
            index -= len(p)
        raise IndexError(index)


# ----------------------------------------------------------------- adapters

class SceneFlowDatasets(StereoDataset):
    """FlyingThings3D + Monkaa + Driving
    (reference: core/stereo_datasets.py:123-184)."""

    def __init__(self, aug_params=None, root="datasets",
                 dstype="frames_cleanpass", things_test=False):
        super().__init__(aug_params)
        self.root = root
        self.dstype = dstype
        if things_test:
            self._add_things("TEST")
        else:
            self._add_things("TRAIN")
            self._add_monkaa()
            self._add_driving()

    def _add_things(self, split="TRAIN"):
        original = len(self.disparity_list)
        root = osp.join(self.root, "FlyingThings3D")
        left = sorted(globlib.glob(osp.join(root, self.dstype, split,
                                            "*/*/left/*.png")))
        right = [p.replace("left", "right") for p in left]
        disp = [p.replace(self.dstype, "disparity").replace(".png", ".pfm")
                for p in left]
        # Seeded 400-image validation subset
        # (reference: core/stereo_datasets.py:146-149).
        val_idxs = set(np.random.RandomState(1000).permutation(len(left))[:400])
        for idx, (i1, i2, d) in enumerate(zip(left, right, disp)):
            if (split == "TEST" and idx in val_idxs) or split == "TRAIN":
                self.image_list.append([i1, i2])
                self.disparity_list.append(d)
        logger.info("Added %d from FlyingThings %s",
                    len(self.disparity_list) - original, self.dstype)

    def _add_monkaa(self):
        root = osp.join(self.root, "Monkaa")
        left = sorted(globlib.glob(osp.join(root, self.dstype, "*/left/*.png")))
        for i1 in left:
            self.image_list.append([i1, i1.replace("left", "right")])
            self.disparity_list.append(
                i1.replace(self.dstype, "disparity").replace(".png", ".pfm"))

    def _add_driving(self):
        root = osp.join(self.root, "Driving")
        left = sorted(globlib.glob(osp.join(root, self.dstype,
                                            "*/*/*/left/*.png")))
        for i1 in left:
            self.image_list.append([i1, i1.replace("left", "right")])
            self.disparity_list.append(
                i1.replace(self.dstype, "disparity").replace(".png", ".pfm"))


class ETH3D(StereoDataset):
    """(reference: core/stereo_datasets.py:187-197)"""

    def __init__(self, aug_params=None, root="datasets/ETH3D", split="training"):
        super().__init__(aug_params, sparse=True)
        im0 = sorted(globlib.glob(osp.join(root, f"two_view_{split}/*/im0.png")))
        im1 = sorted(globlib.glob(osp.join(root, f"two_view_{split}/*/im1.png")))
        if split == "training":
            disp = sorted(globlib.glob(
                osp.join(root, "two_view_training_gt/*/disp0GT.pfm")))
        else:
            disp = [osp.join(root, "two_view_training_gt/playground_1l/disp0GT.pfm")
                    ] * len(im0)
        for i1, i2, d in zip(im0, im1, disp):
            self.image_list.append([i1, i2])
            self.disparity_list.append(d)


class SintelStereo(StereoDataset):
    """(reference: core/stereo_datasets.py:199-210)"""

    def __init__(self, aug_params=None, root="datasets/SintelStereo"):
        super().__init__(aug_params, sparse=True,
                         reader=codecs.read_disp_sintel)
        im0 = sorted(globlib.glob(osp.join(root, "training/*_left/*/frame_*.png")))
        im1 = sorted(globlib.glob(osp.join(root, "training/*_right/*/frame_*.png")))
        disp = sorted(globlib.glob(
            osp.join(root, "training/disparities/*/frame_*.png"))) * 2
        for i1, i2, d in zip(im0, im1, disp):
            assert i1.split("/")[-2:] == d.split("/")[-2:], (i1, d)
            self.image_list.append([i1, i2])
            self.disparity_list.append(d)


class FallingThings(StereoDataset):
    """(reference: core/stereo_datasets.py:212-226)"""

    def __init__(self, aug_params=None, root="datasets/FallingThings"):
        super().__init__(aug_params, reader=codecs.read_disp_fallingthings)
        assert os.path.exists(root), root
        with open(osp.join(root, "filenames.txt"), "r") as f:
            filenames = sorted(f.read().splitlines())
        for e in filenames:
            self.image_list.append([osp.join(root, e),
                                    osp.join(root, e.replace("left.jpg",
                                                             "right.jpg"))])
            self.disparity_list.append(
                osp.join(root, e.replace("left.jpg", "left.depth.png")))


class TartanAir(StereoDataset):
    """(reference: core/stereo_datasets.py:228-244)"""

    def __init__(self, aug_params=None, root="datasets", keywords=()):
        super().__init__(aug_params, reader=codecs.read_disp_tartanair)
        assert os.path.exists(root), root
        with open(osp.join(root, "tartanair_filenames.txt"), "r") as f:
            filenames = sorted(
                s for s in f.read().splitlines()
                if "seasonsforest_winter/Easy" not in s)
        for kw in keywords:
            filenames = sorted(s for s in filenames if kw in s.lower())
        for e in filenames:
            self.image_list.append([osp.join(root, e),
                                    osp.join(root, e.replace("_left", "_right"))])
            self.disparity_list.append(
                osp.join(root, e.replace("image_left", "depth_left")
                         .replace("left.png", "left_depth.npy")))


class KITTI(StereoDataset):
    """(reference: core/stereo_datasets.py:246-257)"""

    def __init__(self, aug_params=None, root="datasets/KITTI",
                 image_set="training"):
        super().__init__(aug_params, sparse=True, reader=codecs.read_disp_kitti)
        assert os.path.exists(root), root
        im0 = sorted(globlib.glob(osp.join(root, image_set, "image_2/*_10.png")))
        im1 = sorted(globlib.glob(osp.join(root, image_set, "image_3/*_10.png")))
        if image_set == "training":
            disp = sorted(globlib.glob(osp.join(root, "training",
                                                "disp_occ_0/*_10.png")))
        else:
            disp = [osp.join(root, "training/disp_occ_0/000085_10.png")] * len(im0)
        for i1, i2, d in zip(im0, im1, disp):
            self.image_list.append([i1, i2])
            self.disparity_list.append(d)


class Middlebury(StereoDataset):
    """(reference: core/stereo_datasets.py:260-274)"""

    def __init__(self, aug_params=None, root="datasets/Middlebury", split="F"):
        super().__init__(aug_params, sparse=True,
                         reader=codecs.read_disp_middlebury)
        assert os.path.exists(root), root
        assert split in "FHQ", split
        lines = [osp.basename(p) for p in
                 globlib.glob(osp.join(root, "MiddEval3/trainingF/*"))]
        official = Path(osp.join(root, "MiddEval3/official_train.txt")
                        ).read_text().splitlines()
        lines = [p for p in lines if any(s in p.split("/") for s in official)]
        im0 = sorted(osp.join(root, "MiddEval3", f"training{split}",
                              f"{name}/im0.png") for name in lines)
        im1 = sorted(osp.join(root, "MiddEval3", f"training{split}",
                              f"{name}/im1.png") for name in lines)
        disp = sorted(osp.join(root, "MiddEval3", f"training{split}",
                               f"{name}/disp0GT.pfm") for name in lines)
        assert len(im0) == len(im1) == len(disp) > 0, (root, split)
        for i1, i2, d in zip(im0, im1, disp):
            self.image_list.append([i1, i2])
            self.disparity_list.append(d)


# ----------------------------------------------------------------- mixing

def expand_img_gamma(img_gamma):
    """(GMIN, GMAX) shorthand -> (GMIN, GMAX, GAIN_MIN, GAIN_MAX)."""
    g = tuple(img_gamma)
    if len(g) == 2:
        g = g + (1.0, 1.0)
    if len(g) != 4:
        raise ValueError(f"img_gamma needs 2 or 4 values, got {g}")
    return g


def build_aug_params(image_size, spatial_scale=(0.0, 0.0), noyjitter=False,
                     saturation_range=None, img_gamma=None, do_flip=None):
    """Flag translation (reference: core/stereo_datasets.py:280-286)."""
    aug_params = {"crop_size": tuple(image_size),
                  "min_scale": spatial_scale[0], "max_scale": spatial_scale[1],
                  "do_flip": False, "yjitter": not noyjitter}
    if saturation_range is not None:
        aug_params["saturation_range"] = tuple(saturation_range)
    if img_gamma is not None:
        aug_params["gamma"] = expand_img_gamma(img_gamma)
    if do_flip is not None:
        aug_params["do_flip"] = do_flip
    return aug_params


def fetch_dataset(train_datasets: Sequence[str], aug_params: dict,
                  root_overrides: Optional[dict] = None):
    """Mix datasets by name with the reference's hand-tuned replication
    (reference: core/stereo_datasets.py:288-309)."""
    roots = root_overrides or {}
    train_dataset = None
    for name in train_datasets:
        if re.fullmatch("middlebury_.*", name):
            new = Middlebury(aug_params, split=name.replace("middlebury_", ""),
                             **({"root": roots["middlebury"]}
                                if "middlebury" in roots else {}))
        elif name == "sceneflow":
            kw = {"root": roots["sceneflow"]} if "sceneflow" in roots else {}
            clean = SceneFlowDatasets(aug_params, dstype="frames_cleanpass", **kw)
            final = SceneFlowDatasets(aug_params, dstype="frames_finalpass", **kw)
            new = (clean * 4) + (final * 4)
        elif "kitti" in name:
            kw = {"root": roots["kitti"]} if "kitti" in roots else {}
            new = KITTI(aug_params, **kw)
        elif name == "sintel_stereo":
            kw = {"root": roots["sintel"]} if "sintel" in roots else {}
            new = SintelStereo(aug_params, **kw) * 140
        elif name == "falling_things":
            kw = {"root": roots["falling_things"]} if "falling_things" in roots else {}
            new = FallingThings(aug_params, **kw) * 5
        elif name.startswith("tartan_air"):
            kw = {"root": roots["tartanair"]} if "tartanair" in roots else {}
            new = TartanAir(aug_params, keywords=name.split("_")[2:], **kw)
        elif name == "sl":
            raise NotImplementedError(
                "structured-light datasets are not ported yet; see "
                "ROADMAP.md Queue 1 item 9")
        else:
            raise ValueError(f"unknown dataset: {name}")
        logger.info("Adding %d samples from %s", len(new), name)
        train_dataset = new if train_dataset is None else train_dataset + new
    return train_dataset
