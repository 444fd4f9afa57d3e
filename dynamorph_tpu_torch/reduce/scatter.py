"""Scatter plots as PNGs, drawn with numpy (io/png.py writes them).

The JAX package draws ``PCA.png`` and ``UMAP.png`` with matplotlib; the
card's machine has no matplotlib, so the port rasterizes the same scatter:
per panel, the points' percentile-zoomed axes (``zoom_limits``, the JAX
package's ``zoom_axis``), each point a hollow circle in the "Paired"
colour of its label (matplotlib's ``c=labels, cmap="Paired"`` mapping),
alpha 0.1 over white, and a black frame. It draws no text: no titles, axis
labels, ticks or legend.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..analysis.raster import map_colours
from ..io.png import write_png

ALPHA = 0.1
PANEL = (1440, 1920)        # rows, columns: a 6.4 x 4.8 in figure at 300 dpi
MARGIN = 60                 # px around each panel's frame
RING = (3.5, 5.5)           # a marker's inner and outer radius, px


def zoom_limits(x, y, zoom_cutoff: float = 1) -> Tuple[list, list]:
    """The axes' limits of the JAX package's ``zoom_axis`` (reference
    run_dim_reduction.py:129-141): the ``zoom_cutoff`` and ``100 -
    zoom_cutoff`` percentiles of each coordinate."""
    xlim = [np.percentile(x, zoom_cutoff), np.percentile(x, 100 - zoom_cutoff)]
    ylim = [np.percentile(y, zoom_cutoff), np.percentile(y, 100 - zoom_cutoff)]
    return xlim, ylim


def label_colours(labels) -> np.ndarray:
    """(N, 3) RGB: each label's "Paired" colour under matplotlib's linear
    norm from the smallest label to the largest."""
    return map_colours(labels, "Paired").astype(np.float64)


def _disc_offsets(radii) -> np.ndarray:
    r = int(np.ceil(radii[1]))
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    d = np.hypot(dy, dx)
    keep = (d >= radii[0]) & (d <= radii[1])
    return np.stack([dy[keep], dx[keep]], 1)


def scatter_panel(x, y, colours, xlim, ylim, filled: bool = False,
                  alpha: float = ALPHA, radius: float = RING[1],
                  size=PANEL) -> np.ndarray:
    """One panel, (rows, cols, 3) float32 RGB in [0, 255]: each point a
    hollow ring (or, ``filled``, a disc) of its colour, blended at
    ``alpha`` over white in data order, inside a black frame at
    ``xlim`` / ``ylim``."""
    h, w = size
    img = np.full((h * w, 3), 255.0, np.float32)
    inner_h, inner_w = h - 2 * MARGIN, w - 2 * MARGIN
    span_x = (xlim[1] - xlim[0]) or 1.0
    span_y = (ylim[1] - ylim[0]) or 1.0
    col = MARGIN + np.rint((np.asarray(x) - xlim[0]) / span_x * (inner_w - 1))
    row = MARGIN + np.rint((ylim[1] - np.asarray(y)) / span_y * (inner_h - 1))
    colours = np.asarray(colours, np.float64)
    offsets = _disc_offsets((0.0 if filled else radius - 2.0, radius))
    # points of one colour come in runs (pooled latents are concatenated
    # source by source), and blending a run's hit counts at once is exact
    same = np.all(colours[1:] == colours[:-1], axis=1)
    starts = np.flatnonzero(np.r_[True, ~same])
    ends = np.r_[starts[1:], len(colours)]
    for s, e in zip(starts, ends):
        rr = (row[s:e, None] + offsets[None, :, 0]).ravel()
        cc = (col[s:e, None] + offsets[None, :, 1]).ravel()
        inside = (rr >= MARGIN) & (rr < h - MARGIN) & \
            (cc >= MARGIN) & (cc < w - MARGIN)
        pix, hits = np.unique((rr[inside] * w + cc[inside]).astype(np.int64),
                              return_counts=True)
        keep = ((1.0 - alpha) ** hits)[:, None]
        img[pix] = img[pix] * keep + colours[s] * (1.0 - keep)
    img = img.reshape(h, w, 3)
    draw_frame(img)
    return img


def draw_frame(img: np.ndarray) -> None:
    """The panel's black frame, 2 px, just outside its MARGIN."""
    h, w = img.shape[:2]
    top, bottom, left, right = MARGIN - 2, h - MARGIN + 1, MARGIN - 2, \
        w - MARGIN + 1
    img[top:top + 2, left:right + 1] = 0
    img[bottom - 1:bottom + 1, left:right + 1] = 0
    img[top:bottom + 1, left:left + 2] = 0
    img[top:bottom + 1, right - 1:right + 1] = 0


def _panel(x, y, labels) -> np.ndarray:
    """One panel of the reduction scatter, (rows, cols, 3) float32 RGB."""
    xlim, ylim = zoom_limits(x, y)
    return scatter_panel(x, y, label_colours(labels), xlim, ylim)


def write_scatter_png(path: str, panels: Sequence[Tuple[np.ndarray,
                                                        np.ndarray]],
                      labels, n_cols: int = 3) -> None:
    """Draw each (x, y) panel, coloured by ``labels``, on a grid of
    ``n_cols`` columns (one row if fewer panels) and write the PNG."""
    n_cols = min(n_cols, len(panels))
    n_rows = -(-len(panels) // n_cols)
    h, w = PANEL
    img = np.full((n_rows * h, n_cols * w, 3), 255.0, np.float32)
    for i, (x, y) in enumerate(panels):
        r, c = divmod(i, n_cols)
        img[r * h:(r + 1) * h, c * w:(c + 1) * w] = _panel(x, y, labels)
    write_rgb_png(path, img)


def write_rgb_png(path: str, rgb: np.ndarray) -> None:
    """An RGB float image in [0, 255], rounded to 8 bits (io/png.py takes
    BGR, as cv2.imwrite does)."""
    write_png(path, np.rint(rgb[..., ::-1]).astype(np.uint8))
