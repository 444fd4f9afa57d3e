"""Classical morphology features of single-cell patches, the port of
``dynamorph_tpu/analysis/morphology.py`` (reference
HiddenStateExtractor/cv2_feature.py): cell size and contour area
(:61-75), intensity percentiles (:78-112), the PCA long-axis angle with the
bounding box of the rotated mask (:146-197) and the unrotated aspect ratio
(:200-217). Host numpy, with ``native/contours`` and
``ops.geometry.warp_image`` in place of cv2.

KAZE descriptors (``extract_features``, cv2_feature.py:20-51) have no
cv2-free counterpart here: the function raises.
"""
from __future__ import annotations

import cmath
from typing import List, Tuple

import numpy as np

from ..core.constants import CHANNEL_MAX
from ..native.contours import bounding_rect, contour_area, find_contours
from ..ops.geometry import rotation_matrix_2d, warp_image


def extract_features(x: np.ndarray, vector_size: int = 32):
    """KAZE descriptors: not ported (OpenCV's KAZE has no counterpart in
    the port); raises."""
    raise NotImplementedError(
        "KAZE features (extract_features) need cv2.KAZE_create, which the "
        "port does not use; run dynamorph_tpu.analysis.morphology."
        "extract_features in the JAX package for them")


def _largest_contour(mask: np.ndarray) -> np.ndarray:
    contours = find_contours(np.asarray(mask).astype("uint8"))
    return contours[int(np.argmax([contour_area(c) for c in contours]))]


def get_size(mask: np.ndarray) -> Tuple[float, float]:
    """(pixel count, largest contour area) (reference cv2_feature.py:61-75)."""
    contours = find_contours(np.asarray(mask).astype("uint8"))
    return mask.sum(), np.max([contour_area(c) for c in contours])


def get_intensity_profile(dat, mask=None) -> List[Tuple[float, ...]]:
    """Per-channel (peak, 95th percentile, mean of top 200, sum) intensities
    within the mask (reference cv2_feature.py:78-112); no mask means the
    whole patch."""
    if mask is None:
        mask = np.ones(np.asarray(dat[0]).shape, bool)
    output = []
    for channel_slice in dat:
        channel_slice = channel_slice / CHANNEL_MAX
        bg = 0.0
        peak_int = ((channel_slice - bg) * mask).max()
        sum_int = ((channel_slice - bg) * mask).sum()
        intensities = (channel_slice - bg)[np.where(mask)]
        quantile_int = np.percentile(intensities, 95)
        top200_int = np.mean(sorted(intensities)[-200:])
        output.append((peak_int, quantile_int, top200_int, sum_int))
    return output


def rotate_bound(image: np.ndarray, angle: float) -> np.ndarray:
    """Rotate a 2-D image by ``angle`` degrees with expanded bounds, in its
    own dtype (reference cv2_feature.py:146-170)."""
    h, w = image.shape[:2]
    cx, cy = w / 2, h / 2
    M = rotation_matrix_2d((cx, cy), angle, 1.0)
    cos, sin = np.abs(M[0, 0]), np.abs(M[0, 1])
    nW = int((h * sin) + (w * cos))
    nH = int((h * cos) + (w * sin))
    M[0, 2] += (nW / 2) - cx
    M[1, 2] += (nH / 2) - cy
    return warp_image(image, M, (nW, nH))


def get_angle_apr(mask: np.ndarray) -> Tuple[float, float, float]:
    """Long-axis angle from the PCA of the mask's coordinates and the
    bounding box of the mask rotated by it (reference
    cv2_feature.py:171-197). Returns (width, height, angle)."""
    y, x = np.nonzero(mask)
    x = x - np.mean(x)
    y = y - np.mean(y)
    cov = np.cov(np.stack([x, y], 0))
    evals, evecs = np.linalg.eig(cov)
    main_axis = evecs[:, np.argmax(evals)]
    angle = cmath.polar(complex(*main_axis))[1]
    rotated = rotate_bound(mask, -angle / np.pi * 180)
    rect = bounding_rect(_largest_contour(rotated))
    return rect[2], rect[3], angle


def get_aspect_ratio_no_rotation(mask: np.ndarray) -> Tuple[float, float]:
    """Bounding-box width and height of the unrotated mask's largest
    contour (reference cv2_feature.py:200-217)."""
    rect = bounding_rect(_largest_contour(mask))
    return rect[2], rect[3]
