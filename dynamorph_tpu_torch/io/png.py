"""PNG writing with the standard library (``zlib``), decoding to the pixels
``cv2.imwrite`` writes for the same array.

The JAX package writes its segmentation previews with ``cv2.imwrite`` on
float64 arrays (``dynamorph_tpu/seg/inference.py:245-248``,
``dynamorph_tpu/seg/data.py:243``). cv2 stores floats as 8-bit with a
saturating round half to even (0.5 -> 0, 1.5 -> 2, 254.5 -> 254, 300 ->
255, -3 -> 0), a 2-D array as gray, a 3-channel one as BGR and a
4-channel one as BGRA; a uint16 array it stores as 16-bit gray. ``write_png`` does the same; its bytes are
its own (filter 0 on every row, zlib level 1).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + \
        struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def _pixels(image: np.ndarray) -> np.ndarray:
    """The array cv2 would store: uint8 and uint16 as they are, floats
    rounded half to even and saturated to uint8."""
    a = np.asarray(image)
    if a.dtype in (np.uint8, np.uint16):
        return a
    if a.dtype.kind != "f":
        raise TypeError(f"unsupported image dtype {a.dtype}")
    return np.clip(np.rint(a), 0, 255).astype(np.uint8)


def write_png(path: str, image: np.ndarray) -> None:
    """Write a 2-D (gray), (H, W, 3) BGR or (H, W, 4) BGRA image as
    cv2.imwrite would."""
    a = _pixels(image)
    if a.ndim == 2:
        color_type = 0
    elif a.ndim == 3 and a.shape[2] == 3:
        color_type = 2
        a = a[:, :, ::-1]                      # BGR -> RGB
    elif a.ndim == 3 and a.shape[2] == 4:
        color_type = 6
        a = a[:, :, [2, 1, 0, 3]]              # BGRA -> RGBA
    else:
        raise ValueError(f"unsupported image shape {a.shape}")
    height, width = a.shape[:2]
    if a.dtype == np.uint16:
        if color_type != 0:
            raise ValueError("16-bit images are written as gray only")
        a = a.astype(">u2")
    rows = np.ascontiguousarray(a).reshape(height, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8 * a.dtype.itemsize,
                         color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header) +
                _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) +
                _chunk(b"IEND", b""))
