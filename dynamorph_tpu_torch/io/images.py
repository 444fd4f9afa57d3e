"""Display conversion for reconstruction images (reference
SingleCellPatch/extract_patches.py:314-334)."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def im_bit_convert(im: np.ndarray, bit: int = 16, norm: bool = False,
                   limit: Optional[Sequence[float]] = None) -> np.ndarray:
    im = im.astype(np.float32, copy=False)
    if norm:
        # None/empty -> min-max (reference im_bit_convert's falsy check,
        # extract_patches.py:314-325)
        if limit is None or len(limit) == 0:
            limit = [np.nanmin(im[:]), np.nanmax(im[:])]
        denom = (limit[1] - limit[0]) or 1.0
        im = (im - limit[0]) / denom * (2 ** bit - 1)
    im = np.clip(im, 0, 2 ** bit - 1)
    return im.astype(np.uint8 if bit == 8 else np.uint16, copy=False)


def im_adjust(img: np.ndarray, tol: float = 1, bit: int = 8) -> np.ndarray:
    """Percentile contrast stretch for display."""
    limit = np.percentile(img, [tol, 100 - tol])
    return im_bit_convert(img, bit=bit, norm=True, limit=limit.tolist())
