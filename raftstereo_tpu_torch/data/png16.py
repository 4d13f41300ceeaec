"""Minimal pure-numpy 16-bit PNG codec (read + write, non-interlaced).

A copy of the JAX package's ``data/png16.py`` with the pure-Python
scanline defilter only (no native helper).

The reference reads/writes KITTI's 16-bit PNGs through OpenCV
(reference: core/utils/frame_utils.py:117-127,166-170); cv2/imageio are
not required here, and PIL cannot handle 16-bit RGB PNGs.  KITTI needs exactly two
shapes: 16-bit grayscale (disparity) and 16-bit RGB (flow+valid), both
non-interlaced — small enough to implement directly on zlib.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _defilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG scanline filters -> (h, stride) bytes."""
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros((stride,), np.int32)
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            pass
        elif ftype == 1:                        # Sub: per-lane prefix sum
            lanes = line[: (stride // bpp) * bpp].reshape(-1, bpp)
            np.cumsum(lanes, axis=0, out=lanes)
            line[: lanes.size] = lanes.reshape(-1)
        elif ftype == 2:                        # Up
            line += prev
        elif ftype == 3:                        # Average
            for x in range(stride):
                a = line[x - bpp] & 0xFF if x >= bpp else 0
                line[x] += (a + prev[x]) >> 1
        elif ftype == 4:                        # Paeth
            lp = line.tolist()
            pv = prev.tolist()
            for x in range(stride):
                a = lp[x - bpp] & 0xFF if x >= bpp else 0
                b = pv[x]
                c = pv[x - bpp] & 0xFF if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                lp[x] += a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            line = np.asarray(lp, np.int32)
        else:
            raise ValueError(f"bad filter {ftype}")
        line &= 0xFF
        out[y] = line
        prev = line
    return out


def read_png16(path: str) -> np.ndarray:
    """Read an 8- or 16-bit, gray/RGB/RGBA, non-interlaced PNG -> (H, W[, C])."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == _SIG, "not a PNG"
    pos = 8
    idat = b""
    meta = None
    while pos < len(data):
        (length,), ctype = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", chunk)
            assert interlace == 0, "interlaced PNG unsupported"
            meta = (w, h, depth, color)
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
        pos += 12 + length
    assert meta is not None, "missing IHDR"
    w, h, depth, color = meta
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    bpp = channels * (depth // 8)              # bytes per pixel
    stride = w * bpp
    raw = zlib.decompress(idat)
    assert len(raw) == h * (stride + 1), "bad IDAT size"
    out = _defilter(raw, h, stride, bpp)

    if depth == 16:
        arr = out.reshape(h, w, channels, 2)
        arr = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
    else:
        arr = out.reshape(h, w, channels).astype(np.uint8)
    return arr[..., 0] if channels == 1 else arr


def write_png16(path: str, arr: np.ndarray) -> None:
    """Write uint16 (H, W) or (H, W, 3) as a 16-bit non-interlaced PNG."""
    assert arr.dtype == np.uint16, arr.dtype
    if arr.ndim == 2:
        color, channels = 0, 1
    else:
        assert arr.shape[2] == 3, arr.shape
        color, channels = 2, 3
    h, w = arr.shape[:2]
    be = arr.astype(">u2").tobytes()
    stride = w * channels * 2
    raw = bytearray()
    for y in range(h):
        raw.append(0)                           # filter: None
        raw += be[y * stride:(y + 1) * stride]

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        out = struct.pack(">I", len(payload)) + ctype + payload
        return out + struct.pack(">I", zlib.crc32(ctype + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 16, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(bytes(raw), 6))
                + chunk(b"IEND", b""))
