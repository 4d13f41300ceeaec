"""Disparity visualisation: jet colormap + PNG writer, the twin of the
JAX package's ``raftstereo_tpu/utils/viz.py`` (the reference demo's
matplotlib jet ramp in numpy, written out through PIL)."""

from __future__ import annotations

from typing import Optional

import numpy as np
from PIL import Image


def jet(x: np.ndarray) -> np.ndarray:
    """Map values in [0, 1] to the classic jet RGB ramp, uint8 (H, W, 3)."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0.0, 1.0)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0.0, 1.0)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0.0, 1.0)
    return (np.stack([r, g, b], axis=-1) * 255.0 + 0.5).astype(np.uint8)


def colorize(arr: np.ndarray, vmin: Optional[float] = None,
             vmax: Optional[float] = None) -> np.ndarray:
    """Normalise a scalar field to [0, 1] and apply jet (matplotlib
    ``imsave`` semantics: min/max of the data unless given)."""
    arr = np.asarray(arr, np.float32)
    lo = float(np.nanmin(arr)) if vmin is None else vmin
    hi = float(np.nanmax(arr)) if vmax is None else vmax
    scale = hi - lo if hi > lo else 1.0
    return jet((arr - lo) / scale)


def save_disparity_png(path: str, disparity: np.ndarray,
                       vmin: Optional[float] = None,
                       vmax: Optional[float] = None) -> None:
    """Write a jet-colormapped disparity image (reference: demo.py:49)."""
    Image.fromarray(colorize(disparity, vmin, vmax)).save(path)
