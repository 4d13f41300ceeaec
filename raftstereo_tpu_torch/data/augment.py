"""Host-side augmentation, numpy + PIL: a copy of the JAX package's
``data/augment.py``.

Capability mirror of the reference's dense and sparse augmentors
(reference: core/utils/augmentor.py:60-317): photometric jitter (brightness,
contrast, saturation, hue, gamma), eraser occlusion, random scale/stretch with
flow rescaling, stereo-aware flips, y-jitter crop simulating imperfect
rectification, and the sparse scatter-based flow rescale.

Randomness runs through an explicit ``np.random.Generator`` (the loader seeds
one per worker), not global state.  Probabilities and value ranges match the
reference; exact draw order does not (augmentation needs statistical, not
bitwise, parity).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from PIL import Image


# ------------------------------------------------------------ primitives

def resize_bilinear(arr: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """cv2.INTER_LINEAR-style resize (half-pixel centers, edge clamp)."""
    h, w = arr.shape[:2]
    oh, ow = int(round(h * fy)), int(round(w * fx))
    if (oh, ow) == (h, w):
        return arr.copy()

    def axis_idx(n_in, n_out):
        pos = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
        pos = np.clip(pos, 0, n_in - 1)
        i0 = np.floor(pos).astype(np.int64)
        i1 = np.minimum(i0 + 1, n_in - 1)
        return i0, i1, (pos - i0).astype(np.float32)

    y0, y1, wy = axis_idx(h, oh)
    x0, x1, wx = axis_idx(w, ow)
    a = arr.astype(np.float32)
    # In-place accumulation on the fancy-index copies: same arithmetic as
    # t0*(1-w) + t1*w with half the full-size temporaries (this runs per
    # sample on the host; the loader is CPU-bound, SURVEY.md §7 part 6).
    # Tuple indices, not `wy[:, None, *trail]`: starred expressions inside a
    # subscript need python >= 3.11, and this must import on 3.10.
    trail = (None,) * (arr.ndim - 2)
    wy_b = wy[(slice(None), None) + trail]
    wx_b = wx[(None, slice(None)) + trail]
    t = a[y1]
    t -= a[y0]
    t *= wy_b
    t += a[y0]
    a = t
    t = a[:, x1]
    t -= a[:, x0]
    t *= wx_b
    t += a[:, x0]
    a = t
    if np.issubdtype(arr.dtype, np.integer):
        info = np.iinfo(arr.dtype)
        return np.clip(np.round(a), info.min, info.max).astype(arr.dtype)
    return a.astype(arr.dtype)


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(b + factor * (a - b), 0, 255)


def _grayscale(img: np.ndarray) -> np.ndarray:
    g = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return g[..., None]


def adjust_brightness(img, factor):
    return _blend(img.astype(np.float32), np.zeros_like(img, np.float32), factor)


def adjust_contrast(img, factor):
    mean = _grayscale(img.astype(np.float32)).mean()
    return _blend(img.astype(np.float32), np.full_like(img, mean, np.float32), factor)


def adjust_saturation(img, factor):
    g = np.broadcast_to(_grayscale(img.astype(np.float32)), img.shape)
    return _blend(img.astype(np.float32), g, factor)


def adjust_hue(img: np.ndarray, shift: float) -> np.ndarray:
    """Hue rotation by ``shift`` in [-0.5, 0.5] turns, via PIL's 8-bit HSV
    (same quantisation torchvision uses for PIL inputs)."""
    hsv = np.array(Image.fromarray(img.astype(np.uint8)).convert("HSV"))
    hsv[..., 0] = (hsv[..., 0].astype(np.int16)
                   + int(round(shift * 255))) % 256
    return np.array(Image.fromarray(hsv, "HSV").convert("RGB")).astype(np.float32)


def adjust_gamma(img, gamma, gain=1.0):
    return np.clip(255.0 * gain * (img.astype(np.float32) / 255.0) ** gamma, 0, 255)


class ColorJitter:
    """torchvision-equivalent jitter: random factors, random op order
    (reference: core/utils/augmentor.py:78,200)."""

    def __init__(self, brightness=0.0, contrast=0.0,
                 saturation: Sequence[float] = (1.0, 1.0), hue=0.0,
                 gamma: Sequence[float] = (1, 1, 1, 1)):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = tuple(saturation)
        self.hue = hue
        self.gamma = tuple(gamma)

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        img = img.astype(np.float32)
        ops = []   # (fn, factor) pairs — factor bound per op, not late-bound
        if self.brightness:
            ops.append((adjust_brightness,
                        rng.uniform(max(0, 1 - self.brightness),
                                    1 + self.brightness)))
        if self.contrast:
            ops.append((adjust_contrast,
                        rng.uniform(max(0, 1 - self.contrast),
                                    1 + self.contrast)))
        if self.saturation != (1.0, 1.0):
            ops.append((adjust_saturation, rng.uniform(*self.saturation)))
        if self.hue:
            ops.append((adjust_hue, rng.uniform(-self.hue, self.hue)))
        for i in rng.permutation(len(ops)):
            fn, factor = ops[i]
            img = fn(img, factor)
        gmin, gmax, gainmin, gainmax = self.gamma
        if (gmin, gmax, gainmin, gainmax) != (1, 1, 1, 1):
            img = adjust_gamma(img, rng.uniform(gmin, gmax),
                               rng.uniform(gainmin, gainmax))
        return np.clip(img, 0, 255).astype(np.uint8)


# ------------------------------------------------------------ dense

class FlowAugmentor:
    """Dense-GT augmentor (reference: core/utils/augmentor.py:60-182)."""

    def __init__(self, crop_size: Tuple[int, int], min_scale=-0.2, max_scale=0.5,
                 do_flip=False, yjitter=False, saturation_range=(0.6, 1.4),
                 gamma=(1, 1, 1, 1), photometric=True):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 1.0
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.yjitter = yjitter
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        # photometric=False skips jitter+eraser on the host — they run
        # on-device instead (data/device_aug.py, --device_photometric).
        self.photometric = photometric
        self.photo = ColorJitter(brightness=0.4, contrast=0.4,
                                 saturation=saturation_range, hue=0.5 / 3.14,
                                 gamma=gamma)
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5

    def color_transform(self, img1, img2, rng):
        if rng.random() < self.asymmetric_color_aug_prob:
            return self.photo(img1, rng), self.photo(img2, rng)
        stack = self.photo(np.concatenate([img1, img2], axis=0), rng)
        return np.split(stack, 2, axis=0)

    def eraser_transform(self, img1, img2, rng, bounds=(50, 100)):
        ht, wd = img1.shape[:2]
        if rng.random() < self.eraser_aug_prob:
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            img2 = img2.copy()
            for _ in range(rng.integers(1, 3)):
                x0 = rng.integers(0, wd)
                y0 = rng.integers(0, ht)
                dx = rng.integers(bounds[0], bounds[1])
                dy = rng.integers(bounds[0], bounds[1])
                img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
        return img1, img2

    def spatial_transform(self, img1, img2, flow, rng):
        ht, wd = img1.shape[:2]
        min_scale = max((self.crop_size[0] + 8) / ht, (self.crop_size[1] + 8) / wd)
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if rng.random() < self.stretch_prob:
            scale_x *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
            scale_y *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
        scale_x = max(scale_x, min_scale)
        scale_y = max(scale_y, min_scale)

        if rng.random() < self.spatial_aug_prob:
            img1 = resize_bilinear(img1, scale_x, scale_y)
            img2 = resize_bilinear(img2, scale_x, scale_y)
            flow = resize_bilinear(flow, scale_x, scale_y)
            flow = flow * np.array([scale_x, scale_y], np.float32)

        if self.do_flip:
            if rng.random() < self.h_flip_prob and self.do_flip == "hf":
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = flow[:, ::-1] * np.array([-1.0, 1.0], np.float32)
            if rng.random() < self.h_flip_prob and self.do_flip == "h":
                # Stereo flip: swap eyes AND mirror (preserves sign convention).
                img1, img2 = img2[:, ::-1], img1[:, ::-1]
            if rng.random() < self.v_flip_prob and self.do_flip == "v":
                img1 = img1[::-1, :]
                img2 = img2[::-1, :]
                flow = flow[::-1, :] * np.array([1.0, -1.0], np.float32)

        ch, cw = self.crop_size
        if self.yjitter:
            # Imperfect-rectification simulation: right crop jittered ±2 rows.
            y0 = rng.integers(2, img1.shape[0] - ch - 2)
            x0 = rng.integers(2, img1.shape[1] - cw - 2)
            y1 = y0 + rng.integers(-2, 3)
            img1 = img1[y0:y0 + ch, x0:x0 + cw]
            img2 = img2[y1:y1 + ch, x0:x0 + cw]
            flow = flow[y0:y0 + ch, x0:x0 + cw]
        else:
            y0 = rng.integers(0, img1.shape[0] - ch + 1)
            x0 = rng.integers(0, img1.shape[1] - cw + 1)
            img1 = img1[y0:y0 + ch, x0:x0 + cw]
            img2 = img2[y0:y0 + ch, x0:x0 + cw]
            flow = flow[y0:y0 + ch, x0:x0 + cw]
        return img1, img2, flow

    def __call__(self, img1, img2, flow, rng: np.random.Generator):
        if self.photometric:
            img1, img2 = self.color_transform(img1, img2, rng)
            img1, img2 = self.eraser_transform(img1, img2, rng)
        img1, img2, flow = self.spatial_transform(img1, img2, flow, rng)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow))


# ------------------------------------------------------------ sparse

class SparseFlowAugmentor:
    """Sparse-GT augmentor with scatter-based flow rescale
    (reference: core/utils/augmentor.py:184-317)."""

    def __init__(self, crop_size: Tuple[int, int], min_scale=-0.2, max_scale=0.5,
                 do_flip=False, yjitter=False, saturation_range=(0.7, 1.3),
                 gamma=(1, 1, 1, 1), photometric=True):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photometric = photometric
        self.photo = ColorJitter(brightness=0.3, contrast=0.3,
                                 saturation=saturation_range, hue=0.3 / 3.14,
                                 gamma=gamma)
        self.eraser_aug_prob = 0.5

    def color_transform(self, img1, img2, rng):
        stack = self.photo(np.concatenate([img1, img2], axis=0), rng)
        return np.split(stack, 2, axis=0)

    def eraser_transform(self, img1, img2, rng):
        ht, wd = img1.shape[:2]
        if rng.random() < self.eraser_aug_prob:
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            img2 = img2.copy()
            for _ in range(rng.integers(1, 3)):
                x0 = rng.integers(0, wd)
                y0 = rng.integers(0, ht)
                dx = rng.integers(50, 100)
                dy = rng.integers(50, 100)
                img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
        return img1, img2

    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
        """Rescale sparse flow by scattering valid samples into the new grid
        (reference: core/utils/augmentor.py:223-255)."""
        ht, wd = flow.shape[:2]
        # Index only the valid pixels instead of materializing a full
        # (H*W, 2) coordinate grid per call — the scatter itself touches a
        # few thousand points, the grid was ~10x the whole function's work.
        ys, xs = np.nonzero(valid >= 1)
        flow0 = flow[ys, xs].astype(np.float32)
        ht1, wd1 = int(round(ht * fy)), int(round(wd * fx))
        flow1 = flow0 * np.asarray([fx, fy])          # f64, as before
        xi = np.round(xs * fx).astype(np.int32)
        yi = np.round(ys * fy).astype(np.int32)
        keep = (xi > 0) & (xi < wd1) & (yi > 0) & (yi < ht1)
        flow_img = np.zeros((ht1, wd1, 2), np.float32)
        valid_img = np.zeros((ht1, wd1), np.int32)
        flow_img[yi[keep], xi[keep]] = flow1[keep]
        valid_img[yi[keep], xi[keep]] = 1
        return flow_img, valid_img

    def spatial_transform(self, img1, img2, flow, valid, rng):
        ht, wd = img1.shape[:2]
        min_scale = max((self.crop_size[0] + 1) / ht, (self.crop_size[1] + 1) / wd)
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = max(scale, min_scale)

        if rng.random() < self.spatial_aug_prob:
            img1 = resize_bilinear(img1, scale_x, scale_y)
            img2 = resize_bilinear(img2, scale_x, scale_y)
            flow, valid = self.resize_sparse_flow_map(flow, valid, scale_x, scale_y)

        if self.do_flip:
            if rng.random() < self.h_flip_prob and self.do_flip == "hf":
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = flow[:, ::-1] * np.array([-1.0, 1.0], np.float32)
                valid = valid[:, ::-1]
            if rng.random() < self.h_flip_prob and self.do_flip == "h":
                img1, img2 = img2[:, ::-1], img1[:, ::-1]
            if rng.random() < self.v_flip_prob and self.do_flip == "v":
                img1 = img1[::-1, :]
                img2 = img2[::-1, :]
                flow = flow[::-1, :] * np.array([1.0, -1.0], np.float32)
                valid = valid[::-1, :]

        # Margin-biased crop favouring image borders
        # (reference: core/utils/augmentor.py:291-298).
        ch, cw = self.crop_size
        margin_y, margin_x = 20, 50
        y0 = rng.integers(0, img1.shape[0] - ch + margin_y)
        x0 = rng.integers(-margin_x, img1.shape[1] - cw + margin_x)
        y0 = int(np.clip(y0, 0, img1.shape[0] - ch))
        x0 = int(np.clip(x0, 0, img1.shape[1] - cw))
        img1 = img1[y0:y0 + ch, x0:x0 + cw]
        img2 = img2[y0:y0 + ch, x0:x0 + cw]
        flow = flow[y0:y0 + ch, x0:x0 + cw]
        valid = valid[y0:y0 + ch, x0:x0 + cw]
        return img1, img2, flow, valid

    def __call__(self, img1, img2, flow, valid, rng: np.random.Generator):
        if self.photometric:
            img1, img2 = self.color_transform(img1, img2, rng)
            img1, img2 = self.eraser_transform(img1, img2, rng)
        img1, img2, flow, valid = self.spatial_transform(img1, img2, flow,
                                                         valid, rng)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow), np.ascontiguousarray(valid))
