"""Classical morphology features of single-cell patches, the port of
``dynamorph_tpu/analysis/morphology.py`` (reference
HiddenStateExtractor/cv2_feature.py): cell size and contour area
(:61-75), intensity percentiles (:78-112), the PCA long-axis angle with the
bounding box of the rotated mask (:146-197) and the unrotated aspect ratio
(:200-217). Host numpy, with ``native/contours`` and
``ops.geometry.warp_image`` in place of cv2. The KAZE descriptors
(``extract_features``, cv2_feature.py:20-51) come from
``analysis/kaze.py``, OpenCV's KAZE written in torch, on the card by
default.
"""
from __future__ import annotations

import cmath
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.constants import CHANNEL_MAX
from ..core.device import resolve_device
from ..native.contours import bounding_rect, contour_area, find_contours
from ..ops.geometry import rotation_matrix_2d, warp_image
from . import kaze


def extract_features(x: np.ndarray, vector_size: int = 32,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Optional[np.ndarray]:
    """KAZE descriptors per channel slice (reference cv2_feature.py:20-51,
    dynamorph_tpu/analysis/morphology.py:26-49): each slice of
    ``x.astype("uint8")`` gets ``cv2.KAZE_create()``'s keypoints
    (``analysis/kaze.py``, on ``device``, the card by default), the
    ``vector_size`` strongest by a stable sort on descending response,
    and their 64-d descriptors, flattened and zero-padded to
    ``vector_size * 64``. The (C, vector_size * 64) rows are float32 when
    every slice fills its row, else float64 (the padding's zeros promote
    them, as ``np.concatenate`` does in the JAX package). On any error the
    function prints ``Error: ...`` and returns None, as the JAX one does.
    """
    dev = resolve_device("cuda" if device is None else device)
    x = x.astype("uint8")
    try:
        if x.ndim != 3 or min(x.shape[1:]) < 3:
            raise ValueError(f"KAZE takes 2-D slices of at least 3 x 3 "
                             f"pixels, not a stack of shape {x.shape}")
        found = kaze.detect_and_compute(torch.from_numpy(x).to(dev),
                                        top=vector_size)
        dscs = []
        needed = vector_size * kaze.DESCRIPTOR_SIZE
        for kp, dsc in found:
            dsc = dsc.flatten() if len(kp) else np.zeros((0,))
            if dsc.size < needed:
                dsc = np.concatenate([dsc, np.zeros(needed - dsc.size)])
            dscs.append(dsc)
        return np.stack(dscs, 0)
    except Exception as e:  # the JAX function's contract: None, not raise
        print("Error: " + str(e))
        return None


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
