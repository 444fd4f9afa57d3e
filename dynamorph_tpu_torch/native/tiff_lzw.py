"""ctypes wrapper for the native TIFF LZW decoder (tiff_lzw.cpp)."""
from __future__ import annotations

import ctypes

import numpy as np

from . import NativeError, load

_UINT8_C = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _lib() -> ctypes.CDLL:
    lib = load("tiff_lzw")
    lib.tiff_lzw_decode.restype = ctypes.c_int64
    lib.tiff_lzw_decode.argtypes = [_UINT8_C, ctypes.c_int64, _UINT8_C,
                                    ctypes.c_int64]
    return lib


def lzw_decode(data: bytes, size: int) -> np.ndarray:
    """The first ``size`` bytes that one LZW-compressed TIFF strip decodes
    to (uint8); fewer where the strip ends early. Raises NativeError on a
    corrupt strip."""
    src = np.frombuffer(data, np.uint8)
    dst = np.empty(size, np.uint8)
    n = _lib().tiff_lzw_decode(np.ascontiguousarray(src), len(src), dst,
                               size)
    if n < 0:
        raise NativeError("corrupt LZW strip: a code outside the table")
    return dst[:n]
