"""PNG writing and reading with the standard library (``zlib``): the
pixels ``cv2.imwrite`` writes for the same array, and those ``cv2.imread``
returns for a file.

The JAX package writes its segmentation previews with ``cv2.imwrite`` on
float64 arrays (``dynamorph_tpu/seg/inference.py:245-248``,
``dynamorph_tpu/seg/data.py:243``). cv2 stores floats as 8-bit with a
saturating round half to even (0.5 -> 0, 1.5 -> 2, 254.5 -> 254, 300 ->
255, -3 -> 0), a 2-D array as gray, a 3-channel one as BGR and a
4-channel one as BGRA; a uint16 array it stores as 16-bit gray.
``write_png`` does the same; its bytes are its own (filter 0 on every
row, zlib level 1).

``read_png`` decodes 8-bit, non-interlaced gray, RGB and RGBA files
with any of the five row filters, in two of cv2's modes: "color" (BGR,
alpha dropped, gray repeated) and "gray", where a color pixel becomes
libpng's
``(9797 R + 19234 G + 3737 B) >> 15`` (cv2 asks libpng for weights 0.299
and 0.587, which it truncates to 1/32768) unless R = G = B. The None, Sub
and Up filters are undone with numpy; Average and Paeth, which need the
pixel to their left first, a pixel at a time (cv2 writes them; the port
writes filter 0 only).
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


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, height: int, row_bytes: int, bpp: int
              ) -> np.ndarray:
    data = np.frombuffer(raw, np.uint8).reshape(height, row_bytes + 1)
    out = np.zeros((height, row_bytes), np.int64)
    prev = np.zeros(row_bytes, np.int64)
    for y in range(height):
        kind, line = data[y, 0], data[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:            # Sub: a running sum per byte of a pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif kind == 2:            # Up
            cur = (line + prev) & 255
        elif kind in (3, 4):       # Average, Paeth
            cur = np.zeros(row_bytes, np.int64)
            for x in range(0, row_bytes, bpp):
                a = cur[x - bpp:x] if x else np.zeros(bpp, np.int64)
                b = prev[x:x + bpp]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp:x] if x else np.zeros(bpp, np.int64)
                    pred = _paeth(a, b, c)
                cur[x:x + bpp] = (line[x:x + bpp] + pred) & 255
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)


def read_png(path: str, mode: str = "color") -> np.ndarray:
    """An 8-bit PNG as ``cv2.imread`` returns it: ``mode`` "color" (the
    default flag) or "gray" (IMREAD_GRAYSCALE)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind, body = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    width, height, depth, color_type, _, _, interlace = header
    channels = {0: 1, 2: 3, 6: 4}.get(color_type)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray, RGB "
                         f"and RGBA PNGs are read (depth {depth}, color "
                         f"type {color_type}, interlace {interlace})")
    px = _unfilter(zlib.decompress(b"".join(idat)), height,
                   width * channels, channels).reshape(height, width,
                                                       channels)
    color = px[..., :3] if channels == 4 else px
    if mode == "gray":
        if color.shape[-1] == 1:
            return np.ascontiguousarray(color[..., 0])
        c = color.astype(np.int64)
        r, g, b = c[..., 0], c[..., 1], c[..., 2]
        y = (9797 * r + 19234 * g + 3737 * b) >> 15
        return np.where((r == g) & (r == b), r, y).astype(np.uint8)
    if mode == "color":
        if color.shape[-1] == 1:
            return np.repeat(color, 3, axis=-1)
        return np.ascontiguousarray(color[..., ::-1])
    raise ValueError(f"unknown read mode {mode!r}")
