"""PC-axis sample montages.

Behavioral spec: reference plot_scripts/PC_samples.py and the cpca script's
montage blocks — bucket patches by quantile ranges along a principal
component, average each bucket and sample representatives, emit montage
images. Paths/conditions are parameters instead of the reference's hard-coded
experiment paths.

The port of ``dynamorph_tpu/analysis/pc_samples.py``: host numpy, with the
16-bit grayscale PNGs written by ``io/png.py::write_png`` in place of
``cv2.imwrite`` (the same pixels once decoded).
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from ..io.png import write_png


def quantile_buckets(values: np.ndarray, n_buckets: int = 5) -> List[np.ndarray]:
    """Index arrays for quantile ranges [i/n, (i+1)/n) along ``values``."""
    out = []
    for i in range(n_buckets):
        lo = np.quantile(values, i / n_buckets)
        hi = np.quantile(values, (i + 1) / n_buckets)
        if i == n_buckets - 1:
            sel = (values >= lo) & (values <= hi)
        else:
            sel = (values >= lo) & (values < hi)
        out.append(np.nonzero(sel)[0])
    return out


def enhance_contrast(mat: np.ndarray, a: float = 1.5,
                     b: float = -10000) -> np.ndarray:
    """Linear contrast stretch into uint16 (reference cpca.py helper)."""
    return np.clip(mat.astype(float) * a + b, 0, 65535).astype(np.uint16)


def pc_sample_montage(patches: np.ndarray, pc_values: np.ndarray,
                      output_dir: str, pc_name: str = "PC1",
                      n_buckets: int = 5, n_samples: int = 20,
                      channel: int = 0, seed: int = 0) -> None:
    """Per-quantile-bucket average images + random sample montages.

    Args:
        patches: (N, C, H, W) patch array (model-input scale, [0, 1]-ish).
        pc_values: (N,) PC coordinate per patch.
        output_dir: where `<pc_name>_bucket<i>_aver.png` and
            `<pc_name>_bucket<i>_samples.png` go.
    """
    os.makedirs(output_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    h, w = patches.shape[-2:]
    for i, idx in enumerate(quantile_buckets(pc_values, n_buckets)):
        if len(idx) == 0:
            continue
        aver = patches[idx, channel].mean(axis=0)
        aver_u16 = (np.clip(aver, 0, 1) * 65535).astype(np.uint16)
        write_png(os.path.join(output_dir, f"{pc_name}_bucket{i}_aver.png"),
                  enhance_contrast(aver_u16, a=2, b=-50000))
        take = rng.choice(idx, min(n_samples, len(idx)), replace=False)
        cols = 5
        rows = int(np.ceil(len(take) / cols))
        montage = np.zeros((rows * h, cols * w), np.uint16)
        for j, t in enumerate(take):
            r, c = divmod(j, cols)
            montage[r * h:(r + 1) * h, c * w:(c + 1) * w] = \
                (np.clip(patches[t, channel], 0, 1) * 65535).astype(np.uint16)
        write_png(os.path.join(output_dir,
                               f"{pc_name}_bucket{i}_samples.png"), montage)
