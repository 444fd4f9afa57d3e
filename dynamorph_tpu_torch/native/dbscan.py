"""ctypes wrapper for the native exact grid-DBSCAN (grid_dbscan.cpp): the
labels of sklearn's DBSCAN over unique integer pixel coordinates (see the
source's header for why they are identical)."""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from . import NativeError, load

_INT32_C = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _lib() -> ctypes.CDLL:
    lib = load("grid_dbscan")
    lib.grid_dbscan_mt.restype = ctypes.c_int
    lib.grid_dbscan_mt.argtypes = [
        _INT32_C, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_int32, ctypes.c_int32, _INT32_C]
    return lib


def grid_dbscan(positions: np.ndarray, eps: float, min_samples: int,
                shape: Tuple[int, int],
                threads: Optional[int] = None) -> np.ndarray:
    """DBSCAN labels (int32, -1 = noise) of UNIQUE integer (y, x) points
    on a grid of ``shape`` (the frame's).

    The occupancy grid keeps one index per pixel, so duplicate points would
    diverge from sklearn; they raise ValueError (the pipeline's
    ``np.argwhere`` coordinates are unique by construction). The per-point
    core test runs on ``threads`` host threads, min(8, cpu_count) when None
    (labels are identical for any count); the native call releases the
    GIL, so callers may also cluster several frames at once.
    """
    positions = np.ascontiguousarray(positions, dtype=np.int32)
    n = len(positions)
    if n == 0:
        return np.zeros((0,), np.int32)
    if positions.ndim != 2 or positions.shape[1] != 2:
        raise ValueError(f"positions must be (N, 2), got {positions.shape}")
    if positions.min() < 0 or positions[:, 0].max() >= shape[0] or \
            positions[:, 1].max() >= shape[1]:
        raise ValueError(f"positions fall outside the grid {shape}")
    keys = positions[:, 0].astype(np.int64) * shape[1] + positions[:, 1]
    if len(np.unique(keys)) != n:
        raise ValueError("grid_dbscan: duplicate points (the grid solver "
                         "needs unique pixel coordinates)")
    if threads is None:
        threads = min(8, os.cpu_count() or 1)
    labels = np.empty(n, np.int32)
    rc = _lib().grid_dbscan_mt(positions, n, shape[0], shape[1], float(eps),
                               int(min_samples), int(threads), labels)
    if rc != 0:
        raise NativeError(f"native grid_dbscan returned {rc}")
    return labels
