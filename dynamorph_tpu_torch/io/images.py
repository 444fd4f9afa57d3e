"""Image reading (reference pipeline/preprocess.py:10-26) and display
conversion for reconstruction images (reference
SingleCellPatch/extract_patches.py:314-334).

The JAX package reads images through cv2; the port reads npy and grayscale
TIFFs (io/tiff.py), whose pixels and dtypes are cv2's.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from .tiff import read_tiff_pages


def read_image(file_path: str) -> np.ndarray:
    """2-D grayscale image of any bit depth from an npy or a TIFF file (its
    first page), as ``cv2.imread(path, cv2.IMREAD_ANYDEPTH)`` reads it."""
    if file_path.endswith("npy"):
        return np.load(file_path)
    if not os.path.isfile(file_path):
        raise IOError(f'Image "{file_path}" cannot be found.')
    return read_tiff_pages(file_path)[0]


def read_multipage_tiff(file_path: str) -> np.ndarray:
    """All pages of a raw microscopy multipage TIFF as (T, Y, X) grayscale
    (the preprocess input), as ``cv2.imreadmulti(path,
    flags=cv2.IMREAD_ANYDEPTH)`` reads them."""
    if not os.path.isfile(file_path):
        raise IOError(f'Multipage TIFF "{file_path}" cannot be read.')
    return np.array(read_tiff_pages(file_path))


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
