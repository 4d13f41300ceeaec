"""Tiled inference for very large stereo pairs: the twin of the JAX
package's ``raftstereo_tpu/eval/tiled.py``.

The image is cut into a grid of fixed-shape overlapping tiles (one padded
shape for the whole run, so one set of cuDNN algorithm choices and
allocator blocks), each tile runs a standard test-mode forward, and the
per-tile disparities are blended on the host with linear feather weights
over the overlap.  The left ``disp_margin`` strip of each interior tile
gets zero weight: a match sits at x - d, so a pixel within
``disp_margin`` of an interior tile's left edge cannot see its match
inside the tile.  Tiles touching the image border keep full weight there.
Device memory is O(tile_batch x tile), whatever the image size.

Instance norm takes its statistics per tile, so tile features are not
those of a full-frame pass; what holds for any weights is that a pixel
one tile owns at full weight equals that tile's own forward, blend bands
are convex combinations, and one tile covering the image reproduces the
full-frame pass.  The numpy planning (``plan_tiles``, ``plan_geometry``,
``tile_weight``, ``seam_gradient``) is the JAX package's, copied.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

__all__ = ["plan_tiles", "plan_geometry", "tile_weight", "tiled_infer",
           "seam_gradient"]


def seam_gradient(pred: np.ndarray, gt: np.ndarray) -> float:
    """Seam-quality metric: the largest one-pixel jump of the ERROR field.

    ``max |∇(pred - gt)|`` over both axes.  Subtracting the ground truth
    removes the scene's own gradients, so what remains is stitching
    artifacts: a hard (unfeathered) tile boundary with per-tile bias ``b``
    shows a jump of ~``b`` at the seam, while a correct ``overlap``-pixel
    feather bounds the jump by ~``b / overlap``.
    """
    err = np.asarray(pred, np.float64) - np.asarray(gt, np.float64)
    jumps = [np.abs(np.diff(err, axis=0)).max() if err.shape[0] > 1 else 0.0,
             np.abs(np.diff(err, axis=1)).max() if err.shape[1] > 1 else 0.0]
    return float(max(jumps))


def plan_tiles(size: int, tile: int, stride: int) -> List[int]:
    """Start offsets covering ``[0, size)`` with fixed ``tile`` length.

    Regular grid at ``stride``, with the last tile shifted left so it ends
    exactly at ``size`` (all tiles stay in-bounds and identically shaped).
    """
    if tile >= size:
        return [0]
    n = math.ceil((size - tile) / stride) + 1
    starts = [min(i * stride, size - tile) for i in range(n)]
    # Dedupe (shifting can collide) while preserving order.
    out: List[int] = []
    for s in starts:
        if not out or s != out[-1]:
            out.append(s)
    return out


def plan_geometry(h: int, w: int, tile_hw: Tuple[int, int], overlap: int,
                  disp_margin: int):
    """The exact tile plan ``tiled_infer`` executes for an (h, w) image:
    (th, tw, ys, xs, ph, pw) — rounded tile shape, start offsets, padded
    image shape.  One home for the rounding/stride/clamp rules so callers
    reporting tile counts can never drift from what actually runs."""
    th = min(-(-tile_hw[0] // 32) * 32, -(-h // 32) * 32)
    tw = min(-(-tile_hw[1] // 32) * 32, -(-w // 32) * 32)
    ph, pw = max(h, th), max(w, tw)
    if tw < pw and tw <= disp_margin + overlap:
        raise ValueError(
            f"tile width {tw} must exceed disp_margin+overlap "
            f"({disp_margin}+{overlap}) when tiling horizontally")
    if th < ph and th <= overlap:
        raise ValueError(
            f"tile height {th} must exceed overlap ({overlap}) when tiling "
            f"vertically")
    sy = max(th - overlap, 1)
    sx = max(tw - overlap - (disp_margin if tw < pw else 0), 1)
    return th, tw, plan_tiles(ph, th, sy), plan_tiles(pw, tw, sx), ph, pw


def tile_weight(tile_h: int, tile_w: int, y0: int, x0: int, h: int, w: int,
                overlap: int, disp_margin: int) -> np.ndarray:
    """(tile_h, tile_w) feather-blend weights for a tile placed at (y0, x0).

    Linear ramp 1/(o+1)..1 over ``overlap`` pixels on every edge that is
    interior to the image; weight 0 over the left ``disp_margin`` strip of
    tiles with x0 > 0 (see module docstring).  Edges that coincide with the
    image border keep weight 1 right up to the border.
    """
    wy = np.ones(tile_h, np.float64)
    wx = np.ones(tile_w, np.float64)

    def feather(vec, at_start, o):
        ramp = np.arange(1, o + 1, dtype=np.float64) / (o + 1)
        if at_start:
            vec[:o] = np.minimum(vec[:o], ramp)
        else:
            vec[-o:] = np.minimum(vec[-o:], ramp[::-1])

    oy = max(min(overlap, tile_h), 1)
    ox = max(min(overlap, tile_w), 1)
    if y0 > 0:
        feather(wy, True, oy)
    if y0 + tile_h < h:
        feather(wy, False, oy)
    if x0 > 0:
        feather(wx, True, ox)
        if disp_margin > 0:
            m = min(disp_margin, tile_w)
            wx[:m] = 0.0
            # Restart the feather after the dead strip.
            e = min(m + ox, tile_w)
            ramp = np.arange(1, ox + 1, dtype=np.float64) / (ox + 1)
            wx[m:e] = np.minimum(wx[m:e], ramp[: e - m])
    if x0 + tile_w < w:
        feather(wx, False, ox)
    return (wy[:, None] * wx[None, :]).astype(np.float32)


def tiled_infer(model, image1: np.ndarray, image2: np.ndarray, *,
                iters: int = 32,
                tile_hw: Tuple[int, int] = (1056, 1568),
                overlap: int = 128,
                disp_margin: int = 512,
                infer_fn=None,
                callback=None,
                tile_batch: int = 1) -> np.ndarray:
    """Full-resolution x-flow (negative disparity) for an arbitrarily
    large pair.

    ``model`` carries its weights and device; image1 and image2 are
    (H, W, 3) or (1, H, W, 3) host arrays in [0, 255].  ``tile_hw`` is
    rounded up to a multiple of 32; the stride is tile - overlap (y) and
    tile - overlap - disp_margin (x), so the zero-weight strip is always
    covered by the tile to its left.  ``infer_fn`` optionally replaces
    ``model(t1, t2, iters=iters)`` (returning ``(low, up)``);
    ``callback(done, total)`` reports progress; ``tile_batch`` tiles run
    as one batch, the last group padded by repeating its final tile
    (discarded).  Returns (H, W) float32."""
    img1 = np.asarray(image1, np.float32)
    img2 = np.asarray(image2, np.float32)
    if img1.ndim == 4:
        img1, img2 = img1[0], img2[0]
    h, w = img1.shape[:2]

    th, tw, ys, xs, ph, pw = plan_geometry(h, w, tile_hw, overlap,
                                           disp_margin)
    pad_h, pad_w = ph - h, pw - w
    if pad_h or pad_w:  # small images: replicate-pad up to one tile
        img1 = np.pad(img1, ((0, pad_h), (0, pad_w), (0, 0)), mode="edge")
        img2 = np.pad(img2, ((0, pad_h), (0, pad_w), (0, 0)), mode="edge")

    if infer_fn is None:
        def infer_fn(t1, t2):
            return model(t1, t2, iters=iters)

    dev = model.device
    acc = np.zeros((ph, pw), np.float64)
    wacc = np.zeros((ph, pw), np.float64)
    positions = [(y0, x0) for y0 in ys for x0 in xs]
    total = len(positions)
    done = 0
    bsz = max(int(tile_batch), 1)
    for g in range(0, total, bsz):
        group = positions[g:g + bsz]
        padded = group + [group[-1]] * (bsz - len(group))
        t1, t2 = (torch.as_tensor(np.stack(
            [img[y0:y0 + th, x0:x0 + tw] for y0, x0 in padded]), device=dev)
            for img in (img1, img2))
        _, up = infer_fn(t1, t2)
        d = up[..., 0].cpu().numpy()
        for k, (y0, x0) in enumerate(group):
            wt = tile_weight(th, tw, y0, x0, ph, pw, overlap, disp_margin)
            acc[y0:y0 + th, x0:x0 + tw] += wt.astype(np.float64) * d[k]
            wacc[y0:y0 + th, x0:x0 + tw] += wt
            done += 1
            if callback is not None:
                callback(done, total)

    np.maximum(wacc, 1e-12, out=wacc)
    return (acc / wacc)[:h, :w].astype(np.float32)
