"""Host-side patch normalisation (the part of ``dynamorph_tpu/train/data.py``
the encode path needs)."""
from __future__ import annotations

import numpy as np


def zscore_patch(imgs: np.ndarray) -> np.ndarray:
    """Per-patch per-channel z-score (reference train_utils.py:252-274) —
    the inference-path normalisation used by process_VAE
    (pipeline/patch_VAE.py:418). The eps is float64's."""
    means = np.mean(imgs, axis=(2, 3), keepdims=True)
    stds = np.std(imgs, axis=(2, 3), keepdims=True)
    return (imgs - means) / (stds + np.finfo(float).eps)
