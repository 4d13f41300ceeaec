"""File codecs for every dataset format the framework supports: a copy of
the JAX package's ``data/codecs.py``.

Capability mirror of the reference's readers/writers
(reference: core/utils/frame_utils.py), rebuilt on PIL + numpy + the local
16-bit PNG codec (no cv2/imageio needed).  Each disparity reader
returns (disp, valid) or a bare array; the dataset layer handles both.
"""

from __future__ import annotations

import json
import os
import re
from typing import Tuple, Union

import numpy as np
from PIL import Image

from .png16 import read_png16, write_png16

FLO_MAGIC = 202021.25


# ------------------------------------------------------------------ .flo

def read_flow(path: str) -> np.ndarray:
    """Middlebury .flo: magic float, int32 w/h, (H, W, 2) float32
    (reference: core/utils/frame_utils.py:13-32)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(FLO_MAGIC):
            raise ValueError(f"{path}: bad .flo magic")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flow(path: str, flow: np.ndarray) -> None:
    assert flow.ndim == 3 and flow.shape[2] == 2
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([FLO_MAGIC], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


# ------------------------------------------------------------------ PFM

def read_pfm(path: str) -> np.ndarray:
    """PFM (SceneFlow/Middlebury disparities): bottom-up scanline order,
    sign of scale encodes endianness (reference: core/utils/frame_utils.py:34-69)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file")
        m = re.match(rb"^(\d+)\s+(\d+)\s*$", f.readline())
        if not m:
            raise ValueError(f"{path}: malformed PFM header")
        w, h = map(int, m.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f4")
    shape = (h, w, 3) if channels == 3 else (h, w)
    return np.flipud(data.reshape(shape)).copy()


def write_pfm(path: str, arr: np.ndarray, scale: float = 1.0) -> None:
    arr = np.asarray(arr, np.float32)
    assert arr.ndim in (2, 3)
    color = arr.ndim == 3 and arr.shape[2] == 3
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(f"{-abs(scale)}\n".encode())     # little-endian
        np.flipud(arr).astype("<f4").tofile(f)


# ------------------------------------------------------------------ KITTI

def read_disp_kitti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit disparity png: disp = u16/256, valid where >0
    (reference: core/utils/frame_utils.py:124-127)."""
    disp = read_png16(path).astype(np.float32) / 256.0
    return disp, disp > 0.0


def write_disp_kitti(path: str, disp: np.ndarray) -> None:
    write_png16(path, np.clip(disp * 256.0, 0, 65535).astype(np.uint16))


def read_flow_kitti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit flow png: (u16 - 2^15)/64, channel 2 = valid
    (reference: core/utils/frame_utils.py:117-122)."""
    raw = read_png16(path).astype(np.float32)
    flow = (raw[:, :, :2] - 2 ** 15) / 64.0
    return flow, raw[:, :, 2]


def write_flow_kitti(path: str, flow: np.ndarray) -> None:
    h, w = flow.shape[:2]
    out = np.concatenate([64.0 * flow + 2 ** 15,
                          np.ones((h, w, 1), np.float32)], axis=-1)
    write_png16(path, out.astype(np.uint16))


# ------------------------------------------------------------------ Sintel

def read_disp_sintel(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Sintel RGB-packed disparity + occlusion mask sibling directory
    (reference: core/utils/frame_utils.py:130-136)."""
    a = np.asarray(Image.open(path), np.float64)
    disp = a[..., 0] * 4 + a[..., 1] / 2 ** 6 + a[..., 2] / 2 ** 14
    mask = np.asarray(Image.open(path.replace("disparities", "occlusions")))
    return disp.astype(np.float32), (mask == 0) & (disp > 0)


# ------------------------------------------------------------------ FallingThings

def read_disp_fallingthings(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Depth png + camera json -> disparity = fx * 6cm baseline / depth
    (reference: core/utils/frame_utils.py:139-146)."""
    a = np.asarray(Image.open(path)).astype(np.float32)
    cam = os.path.join(os.path.dirname(path), "_camera_settings.json")
    with open(cam, "r") as f:
        intrinsics = json.load(f)
    fx = intrinsics["camera_settings"][0]["intrinsic_settings"]["fx"]
    with np.errstate(divide="ignore", invalid="ignore"):
        disp = (fx * 6.0 * 100) / a
    return disp, disp > 0


# ------------------------------------------------------------------ TartanAir

def read_disp_tartanair(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """npy depth -> disparity 80/depth (reference: core/utils/frame_utils.py:149-153)."""
    depth = np.load(path)
    with np.errstate(divide="ignore", invalid="ignore"):
        disp = 80.0 / depth
    return disp, disp > 0


# ------------------------------------------------------------------ Middlebury

def read_disp_middlebury(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """MiddEval3 disp0GT.pfm + mask0nocc.png==255 non-occluded mask
    (reference: core/utils/frame_utils.py:156-164)."""
    assert os.path.basename(path) == "disp0GT.pfm", path
    disp = read_pfm(path).astype(np.float32)
    assert disp.ndim == 2
    nocc = path.replace("disp0GT.pfm", "mask0nocc.png")
    assert os.path.exists(nocc), nocc
    mask = np.asarray(Image.open(nocc)) == 255
    assert mask.any()
    return disp, mask


# ------------------------------------------------------------------ generic

def read_gen(path: str) -> Union[np.ndarray, Image.Image]:
    """Extension dispatch (reference: core/utils/frame_utils.py:173-187)."""
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".png", ".jpeg", ".jpg", ".ppm"):
        return Image.open(path)
    if ext in (".bin", ".raw", ".npy"):
        return np.load(path)
    if ext == ".flo":
        return read_flow(path).astype(np.float32)
    if ext == ".pfm":
        arr = read_pfm(path).astype(np.float32)
        return arr if arr.ndim == 2 else arr[:, :, :-1]
    raise ValueError(f"unsupported extension: {path}")
