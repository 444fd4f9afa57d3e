"""ctypes wrapper for the native float64 fused multiply-add (fma.cpp)."""
from __future__ import annotations

import ctypes

import numpy as np

from . import load

_F64_C = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _lib() -> ctypes.CDLL:
    lib = load("fma")
    lib.fma_f64.restype = None
    lib.fma_f64.argtypes = [_F64_C, _F64_C, _F64_C, _F64_C, ctypes.c_int64]
    return lib


def fma(a, b, c) -> np.ndarray:
    """``a * b + c`` rounded once, elementwise in float64 (the arguments
    broadcast)."""
    a, b, c = (np.ascontiguousarray(x, dtype=np.float64)
               for x in np.broadcast_arrays(a, b, c))
    out = np.empty(a.shape, np.float64)
    _lib().fma_f64(a, b, c, out, out.size)
    return out
