"""Baseline TIFF reading and writing without cv2.

The reader returns what ``cv2.imread(path, cv2.IMREAD_ANYDEPTH)`` (the
first page) and ``cv2.imreadmulti(path, flags=cv2.IMREAD_ANYDEPTH)`` (every
page) return for the grayscale TIFFs that microscopes, ImageJ and
``cv2.imwrite`` write: 8- or 16-bit unsigned samples, one sample a pixel,
little- or big-endian, one or several strips a page, uncompressed
(Compression 1) or LZW (Compression 5, decoded by native/tiff_lzw.cpp),
with or without the horizontal predictor (Predictor 2). Anything else
(another compression, BigTIFF, tiles, SamplesPerPixel other than 1,
another bit depth or sample format, a palette or inverted photometric)
raises an ``IOError`` that names it.

The writer is the JAX package's (``dynamorph_tpu/io/tiff.py``):
uncompressed, one strip a page, little-endian, uint8 or uint16, gray or
RGB pages (the validation overlays are uint16 RGB, which PIL cannot
encode). The reader takes gray pages only.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from ..native.tiff_lzw import lzw_decode

# the field types of the tags the reader needs (BYTE, SHORT, LONG): struct
# code and size; tags of other types are skipped
_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4)}

_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_FILL_ORDER, _STRIP_OFFSETS, _SAMPLES, _ROWS_PER_STRIP = 266, 273, 277, 278
_STRIP_BYTES, _PLANAR, _PREDICTOR, _TILE_WIDTH, _SAMPLE_FORMAT = \
    279, 284, 317, 322, 339


def _entry(tag: int, type_: int, count: int, value: int) -> bytes:
    return struct.pack("<HHII", tag, type_, count, value)


def write_multipage_tiff(path: str, stack: np.ndarray) -> None:
    """Write a (T, H, W) gray or (T, H, W, 3) RGB uint8/uint16 stack as a
    multipage TIFF."""
    stack = np.asarray(stack)
    if stack.ndim == 3:
        stack = stack[..., None]
    if stack.ndim != 4 or stack.shape[-1] not in (1, 3) or \
            stack.dtype not in (np.uint8, np.uint16):
        raise ValueError("expect a uint8 or uint16 (T, H, W) or (T, H, W, 3) "
                         f"stack, got {stack.dtype} {stack.shape}")
    t, h, w, c = stack.shape
    bits = 16 if stack.dtype == np.uint16 else 8

    with open(path, "wb") as f:
        f.write(b"II*\x00")
        ifd_offset_pos = f.tell()
        f.write(struct.pack("<I", 0))  # patched later

        prev_next_ptr = ifd_offset_pos
        for page in range(t):
            data = stack[page].astype(stack.dtype.newbyteorder("<")).tobytes()
            data_offset = f.tell()
            f.write(data)
            if f.tell() % 2:        # TIFF requires word-aligned offsets
                f.write(b"\x00")
            # BitsPerSample: inline for one sample, an array for three
            bps_count, bps_value = 1, bits
            if c == 3:
                bps_count, bps_value = 3, f.tell()
                f.write(struct.pack("<3H", bits, bits, bits))

            ifd_offset = f.tell()
            entries = [
                _entry(256, 4, 1, w),                 # ImageWidth
                _entry(257, 4, 1, h),                 # ImageLength
                _entry(258, 3, bps_count, bps_value),  # BitsPerSample
                _entry(259, 3, 1, 1),                 # Compression: none
                _entry(262, 3, 1, 2 if c == 3 else 1),  # Photometric
                _entry(273, 4, 1, data_offset),       # StripOffsets
                _entry(277, 3, 1, c),                 # SamplesPerPixel
                _entry(278, 4, 1, h),                 # RowsPerStrip
                _entry(279, 4, 1, len(data)),         # StripByteCounts
                _entry(284, 3, 1, 1),                 # PlanarConfig: chunky
            ]
            # patch previous IFD's next-pointer to this IFD
            here = f.tell()
            f.seek(prev_next_ptr)
            f.write(struct.pack("<I", ifd_offset))
            f.seek(here)

            f.write(struct.pack("<H", len(entries)))
            for e in entries:
                f.write(e)
            prev_next_ptr = f.tell()
            f.write(struct.pack("<I", 0))  # next IFD (patched or terminal)


def _ifds(buf: bytes, path: str) -> Tuple[str, List[Dict[int, tuple]]]:
    """The byte order ("<" or ">") and every page's tags, {tag: values}."""
    if len(buf) < 8 or buf[:2] not in (b"II", b"MM"):
        raise IOError(f'"{path}" is not a TIFF file')
    bo = "<" if buf[:2] == b"II" else ">"
    magic, offset = struct.unpack(bo + "HI", buf[2:8])
    if magic == 43:
        raise IOError(f'"{path}" is a BigTIFF, which is not supported')
    if magic != 42:
        raise IOError(f'"{path}" is not a TIFF file (magic {magic})')
    pages, seen = [], set()
    while offset:
        if offset in seen or offset + 2 > len(buf):
            raise IOError(f'"{path}": bad IFD offset {offset}')
        seen.add(offset)
        (n,) = struct.unpack_from(bo + "H", buf, offset)
        if offset + 2 + 12 * n + 4 > len(buf):
            raise IOError(f'"{path}": truncated IFD at {offset}')
        tags = {}
        for i in range(n):
            tag, type_, count, raw = struct.unpack_from(
                bo + "HHI4s", buf, offset + 2 + 12 * i)
            if type_ not in _TYPES:
                continue
            code, size = _TYPES[type_]
            if count * size <= 4:
                data, start = raw, 0
            else:
                data, start = buf, struct.unpack(bo + "I", raw)[0]
                if start + count * size > len(buf):
                    raise IOError(f'"{path}": tag {tag} points past the end')
            tags[tag] = struct.unpack_from(f"{bo}{count}{code}", data, start)
        pages.append(tags)
        (offset,) = struct.unpack_from(bo + "I", buf, offset + 2 + 12 * n)
    if not pages:
        raise IOError(f'"{path}" holds no image')
    return bo, pages


def _one(tags: Dict[int, tuple], tag: int, default=None):
    return tags[tag][0] if tag in tags else default


def _page(buf: bytes, bo: str, tags: Dict[int, tuple], path: str
          ) -> np.ndarray:
    """One page's pixels, (H, W) uint8 or uint16 in native byte order."""
    where = f'"{path}"'
    samples = _one(tags, _SAMPLES, 1)
    if samples != 1:
        raise IOError(f"{where}: SamplesPerPixel = {samples}; only grayscale "
                      "(1 sample a pixel) is supported")
    bits = tags.get(_BITS, (1,))
    if len(set(bits)) != 1 or bits[0] not in (8, 16):
        raise IOError(f"{where}: BitsPerSample = {list(bits)}; only 8 and "
                      "16 are supported")
    bits = bits[0]
    compression = _one(tags, _COMPRESSION, 1)
    if compression not in (1, 5):
        raise IOError(f"{where}: Compression = {compression}; only 1 (none) "
                      "and 5 (LZW) are supported")
    checks = ((_SAMPLE_FORMAT, 1, "SampleFormat", "1 (unsigned)"),
              (_PHOTOMETRIC, 1, "PhotometricInterpretation",
               "1 (BlackIsZero)"),
              (_FILL_ORDER, 1, "FillOrder", "1"),
              (_PLANAR, 1, "PlanarConfiguration", "1"))
    for tag, default, name, allowed in checks:
        value = _one(tags, tag, default)
        if value != default:
            raise IOError(f"{where}: {name} = {value}; only {allowed} is "
                          "supported")
    predictor = _one(tags, _PREDICTOR, 1)
    if predictor not in (1, 2):
        raise IOError(f"{where}: Predictor = {predictor}; only 1 (none) and "
                      "2 (horizontal) are supported")
    if _TILE_WIDTH in tags:
        raise IOError(f"{where}: tiled TIFFs are not supported")
    if _STRIP_OFFSETS not in tags or _STRIP_BYTES not in tags:
        raise IOError(f"{where}: no strips")
    width, length = _one(tags, _WIDTH), _one(tags, _LENGTH)
    if not width or not length:
        raise IOError(f"{where}: no image size ({width} x {length})")
    rows = min(_one(tags, _ROWS_PER_STRIP, length), length)
    if rows < 1:
        raise IOError(f"{where}: RowsPerStrip = {rows}")
    offsets, counts = tags[_STRIP_OFFSETS], tags[_STRIP_BYTES]
    row_bytes = width * bits // 8
    n_strips = -(-length // rows)
    if len(offsets) < n_strips or len(counts) < n_strips:
        raise IOError(f"{where}: {len(offsets)} strips for {length} rows of "
                      f"{rows}")
    parts = []
    for s in range(n_strips):
        want = min(rows, length - s * rows) * row_bytes
        strip = buf[offsets[s]:offsets[s] + counts[s]]
        if compression == 5:
            if strip[:2] == b"\x00\x01":
                raise IOError(f"{where}: old-style (pre-TIFF 6) LZW is not "
                              "supported")
            strip = lzw_decode(strip, want).tobytes()
        if len(strip) < want:
            raise IOError(f"{where}: strip {s} holds {len(strip)} bytes, "
                          f"{want} expected")
        parts.append(strip[:want])
    dtype = np.dtype(np.uint8 if bits == 8 else bo + "u2")
    image = np.frombuffer(b"".join(parts), dtype).reshape(length, width)
    image = image.astype(dtype.newbyteorder("="))
    if predictor == 2:
        # horizontal differencing, undone in the sample type (wrapping)
        image = np.cumsum(image, axis=1, dtype=image.dtype)
    return image


def read_tiff_pages(path: str) -> List[np.ndarray]:
    """Every page of a grayscale 8- or 16-bit TIFF, as cv2.imreadmulti
    with IMREAD_ANYDEPTH returns them."""
    with open(path, "rb") as f:
        buf = f.read()
    bo, pages = _ifds(buf, path)
    return [_page(buf, bo, tags, path) for tags in pages]
