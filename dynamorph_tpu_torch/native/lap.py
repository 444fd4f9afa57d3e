"""ctypes wrapper for the native Jonker-Volgenant LAP solver (lap.cpp).

It returns an assignment of the same optimal cost as
scipy.optimize.linear_sum_assignment; where several optima exist the
permutation may differ, so track/matching.py sends small instances (and
non-finite ones, which the solver refuses) to scipy, whose tie-break the
reference's tracks follow.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from . import NativeError, load


def _lib() -> ctypes.CDLL:
    lib = load("lap")
    lib.lapjv.restype = ctypes.c_int
    lib.lapjv.argtypes = [
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.POINTER(ctypes.c_double),
    ]
    return lib


def lap_solve(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Solve a square dense LAP of finite costs. Returns (row_ind, col_ind)
    as scipy's linear_sum_assignment does."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    n = cost.shape[0]
    if cost.shape != (n, n):
        raise ValueError(f"native LAP needs a square matrix, got "
                         f"{cost.shape}")
    row_to_col = np.empty(n, dtype=np.int32)
    total = ctypes.c_double()
    rc = _lib().lapjv(n, cost, row_to_col, ctypes.byref(total))
    if rc != 0:
        raise NativeError(f"native LAP returned {rc}")
    return np.arange(n), row_to_col.astype(np.int64)
