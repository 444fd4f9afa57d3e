"""Contours of binary masks without cv2: ctypes wrappers for contours.cpp
and the two measures that need no native code.

- ``find_contours(mask)``: the list ``cv2.findContours(mask, 1, 2)`` gives
  (RETR_LIST, CHAIN_APPROX_SIMPLE), hole borders included, in cv2's
  contour order and point order; each contour an (n, 2) int32 array of
  (x, y) points, without cv2's middle axis.
- ``contour_area(contour)``: ``cv2.contourArea``, the absolute shoelace
  area.
- ``bounding_rect(contour)``: ``cv2.boundingRect``, (x, y, w, h).
- ``min_area_rect(contour)``: ``cv2.minAreaRect``, ((cx, cy), (w, h),
  angle) in float32 arithmetic, the angle in [-90, 0) degrees as the
  cv2 5.0 that the tests hold it against reports it.

A failed build or load raises ``native.NativeError``; there is no
fallback.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from . import NativeError, load


def _lib() -> ctypes.CDLL:
    lib = load("contours")
    lib.contours_trace.restype = ctypes.c_void_p
    lib.contours_trace.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int, ctypes.c_int]
    for name in ("contours_count", "contours_total"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.contours_copy.restype = None
    lib.contours_copy.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
    lib.contours_free.restype = None
    lib.contours_free.argtypes = [ctypes.c_void_p]
    lib.min_area_rect.restype = ctypes.c_int
    lib.min_area_rect.argtypes = [
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")]
    return lib


def find_contours(mask: np.ndarray) -> List[np.ndarray]:
    """Every border of the non-zero pixels of a 2-D mask, as
    ``cv2.findContours(mask.astype("uint8"), 1, 2)`` lists them."""
    m = np.ascontiguousarray(np.asarray(mask) != 0, dtype=np.uint8)
    if m.ndim != 2:
        raise ValueError(f"find_contours needs a 2-D mask, got {m.shape}")
    lib = _lib()
    handle = lib.contours_trace(m, m.shape[0], m.shape[1])
    if not handle:
        raise NativeError("contours_trace returned no result")
    try:
        n = lib.contours_count(handle)
        xy = np.empty((max(lib.contours_total(handle), 1), 2), np.int32)
        lengths = np.empty(max(n, 1), np.int32)
        lib.contours_copy(handle, xy, lengths)
    finally:
        lib.contours_free(handle)
    return np.split(xy, np.cumsum(lengths[:n])[:-1])[:n] if n else []


def contour_area(contour: np.ndarray) -> float:
    """|shoelace area| of a closed polygon of integer points, as
    ``cv2.contourArea`` (exact: integer products, summed in float64)."""
    p = np.asarray(contour, np.float64).reshape(-1, 2)
    if len(p) < 3:
        return 0.0
    q = np.roll(p, 1, axis=0)
    return float(abs(np.sum(q[:, 0] * p[:, 1] - q[:, 1] * p[:, 0]) * 0.5))


def bounding_rect(contour: np.ndarray) -> Tuple[int, int, int, int]:
    """(x, y, w, h) of the smallest upright box holding the points."""
    p = np.asarray(contour).reshape(-1, 2)
    x0, y0 = p.min(0)
    x1, y1 = p.max(0)
    return int(x0), int(y0), int(x1 - x0 + 1), int(y1 - y0 + 1)


def min_area_rect(contour: np.ndarray):
    """((cx, cy), (w, h), angle) of the rotated rectangle of least area
    around the points, as ``cv2.minAreaRect`` returns it."""
    p = np.ascontiguousarray(np.asarray(contour).reshape(-1, 2),
                             dtype=np.int32)
    out = np.zeros(5, np.float32)
    if _lib().min_area_rect(p, len(p), out) != 0:
        raise NativeError("min_area_rect needs at least one point")
    v = [float(x) for x in out]
    return (v[0], v[1]), (v[2], v[3]), v[4]
