"""Paper-figure generators, the port of ``dynamorph_tpu/analysis/plots.py``
(reference plot_scripts/plottings.py, plotting_cm.py, B4_temp.py), with
the same function names and signatures, drawn with numpy: no matplotlib,
seaborn, pandas, imageio or cv2 (the card's machine has none of the
first four).

- The image helpers equal the JAX package's files pixel for pixel:
  ``plot_patches`` (16-bit PNGs), ``save_patch_movie`` (a GIF through PIL,
  ``1000 / fps`` ms a frame), ``plot_instance_separation`` (tab10 blends,
  written in cv2's BGR file order), ``draw_cell_boxes`` and
  ``plot_trajectory_on_frame`` (cv2 5.0's rectangles and lines at any
  thickness cv2 takes, filled rectangles included, ported in
  ``analysis/raster.py``).
- The matplotlib and seaborn figures are numpy rasters in the style of
  ``reduce/scatter.py``: the same numbers (the correlation matrix, the
  explained-variance curve, the zoomed limits, the histograms) in
  matplotlib's colours (``analysis/raster.py``'s tables), and no text:
  no titles, axis labels, ticks, legends or cell annotations. The
  parameters that only name text (``class_names``, ``xlabel``, ...) are
  kept for the signature and draw nothing.
- The density figures compute what seaborn and matplotlib compute, with
  ``scipy.stats.gaussian_kde`` at Scott's bandwidth: seaborn's
  ``kdeplot`` on a 200-point grid cut 3 bandwidths past the data
  (``kde_curve``, ``joint_kde``, with the filled contours' iso-proportion
  levels), matplotlib's ``violinplot`` on 100 points between the data's
  extremes (``violin_stats``).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..io.png import write_png
from ..reduce.scatter import (MARGIN, PANEL, draw_frame, scatter_panel,
                              write_rgb_png, zoom_limits)
from .pc_samples import enhance_contrast
from .raster import _circle, colormap_lut, line, map_colours, rectangle



def _tab10(i: int) -> np.ndarray:
    """matplotlib's C0, C1, ...: colour ``i`` of tab10, as float64."""
    return colormap_lut("tab10")[i].astype(np.float64)
DPI = 300                   # the JAX figures' savefig dpi
MPL_MARGIN = 0.05           # matplotlib's default autoscale margin
GAP = 16                    # px between side-by-side panels
BAR = 24                    # px: a colour bar's width


def _to_rgb_u8(frame: np.ndarray) -> np.ndarray:
    """uint16-range grayscale frame -> (H, W, 3) uint8 canvas."""
    g = (np.asarray(frame, np.float64) / 256.0).clip(0, 255).astype(np.uint8)
    return np.repeat(g[:, :, None], 3, axis=2)


def _autoscale(v) -> Tuple[float, float]:
    """matplotlib's default data limits: the range padded by 5% a side."""
    lo, hi = float(np.min(v)), float(np.max(v))
    pad = MPL_MARGIN * (hi - lo) if hi > lo else 0.5
    return lo - pad, hi + pad


def _to_px(x, y, xlim, ylim, size=PANEL):
    """Data -> (row, col) float pixel positions inside a panel's frame."""
    h, w = size
    col = MARGIN + (np.asarray(x, np.float64) - xlim[0]) / \
        ((xlim[1] - xlim[0]) or 1.0) * (w - 2 * MARGIN - 1)
    row = MARGIN + (ylim[1] - np.asarray(y, np.float64)) / \
        ((ylim[1] - ylim[0]) or 1.0) * (h - 2 * MARGIN - 1)
    return row, col


def _blank(size=PANEL) -> np.ndarray:
    return np.full(size + (3,), 255.0, np.float32)


def _blend(img, mask, colour, alpha: float = 1.0) -> None:
    img[mask] = img[mask] * (1.0 - alpha) + np.asarray(colour) * alpha


def _polyline(img, rows, cols, colour, thickness: int = 3) -> None:
    """Segments through consecutive points, as thick lines."""
    pts = np.stack([np.rint(cols), np.rint(rows)], 1).astype(int)
    for p, q in zip(pts[:-1], pts[1:]):
        line(img, p, q, colour, thickness)


def _colour_bar(lut_name: str, height: int, width: int = BAR) -> np.ndarray:
    """A vertical bar of the colour map, its top the map's end."""
    return map_colours(np.repeat(np.linspace(1.0, 0.0, height)[:, None],
                                 width, 1), lut_name, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Raw-image figures
# ---------------------------------------------------------------------------

def plot_patches(patches: np.ndarray, out_dir: str, prefix: str = "patch",
                 a: float = 1.5, b: float = -10000.0) -> list:
    """Contrast-enhanced 16-bit patch PNGs (reference plottings.py:52-63).

    patches: (N, H, W) uint16-range grayscale.
    """
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, p in enumerate(np.asarray(patches)):
        out = np.clip(enhance_contrast(p.astype(np.float64), a, b), 0, 65535)
        path = os.path.join(out_dir, f"{prefix}_{i}.png")
        write_png(path, out.astype(np.uint16))
        paths.append(path)
    return paths


def save_patch_movie(patches: np.ndarray, path: str, fps: int = 5,
                     a: float = 1.5, b: float = -10000.0) -> str:
    """Animated grayscale GIF of a patch sequence, ``1000 / fps`` ms a
    frame (reference plottings.py:65-79), through PIL."""
    from PIL import Image

    frames = []
    for p in np.asarray(patches):
        out = np.clip(enhance_contrast(p.astype(np.float64), a, b), 0, 65535)
        frames.append(Image.fromarray(
            (out / 256.0).clip(0, 255).astype(np.uint8)))
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=1000.0 / fps)
    return path


def plot_class_probabilities(probs: np.ndarray, path: str,
                             class_names: Optional[Sequence[str]] = None
                             ) -> str:
    """Per-class probability maps side by side (Fig 2 A2/A3 equivalents,
    reference plottings.py:96-125), each pixel its probability in viridis
    over [0, 1], and a colour bar. probs: (n_classes, H, W) in [0, 1].
    ``class_names`` titled the panels in the JAX figure; no text here."""
    probs = np.asarray(probs)
    n, h, w = probs.shape
    img = np.full((h, n * (w + GAP) + BAR, 3), 255, np.uint8)
    for i in range(n):
        img[:, i * (w + GAP):i * (w + GAP) + w] = map_colours(
            probs[i], "viridis", 0.0, 1.0)
    img[:, n * (w + GAP):] = _colour_bar("viridis", h)
    write_png(path, img[..., ::-1])
    return path


def plot_instance_separation(frame: np.ndarray, positions: np.ndarray,
                             position_labels: np.ndarray, path: str,
                             alpha: float = 0.7) -> str:
    """Blend each cell's pixels with a per-cell tab10 color on the raw frame
    (Fig 2 B1, reference plottings.py:180-204), written as cv2.imwrite
    writes the JAX package's array.

    positions: (M, 2) pixel coords; position_labels: (M,) cell ids (-1 noise).
    """
    mat = _to_rgb_u8(frame).astype(np.float64)
    positions = np.asarray(positions)
    position_labels = np.asarray(position_labels)
    for cid in np.unique(position_labels):
        if cid < 0:
            continue
        pts = positions[position_labels == cid]
        color = colormap_lut("tab10")[int(cid) % 10] / 255.0 * 255.0
        mat[pts[:, 0], pts[:, 1]] = (
            (1 - alpha) * mat[pts[:, 0], pts[:, 1]] + alpha * color)
    write_png(path, mat.astype(np.uint8))
    return path


def draw_cell_boxes(frame: np.ndarray, centers: Sequence, path: str,
                    colors=None, half: int = 64, thickness: int = 3) -> str:
    """Square boxes around cell centers on the raw frame (Fig 2 B2,
    reference plottings.py:205-237 add_box), cv2's thick rectangles."""
    mat = _to_rgb_u8(frame)
    h, w = mat.shape[:2]
    if colors is None:
        colors = [(0, 255, 0)] * len(centers)
    for c, col in zip(centers, colors):
        y0, y1 = int(max(c[0] - half, 0)), int(min(c[0] + half, h - 1))
        x0, x1 = int(max(c[1] - half, 0)), int(min(c[1] + half, w - 1))
        rectangle(mat, (x0, y0), (x1, y1), tuple(int(v) for v in col),
                  thickness)
    write_png(path, mat)
    return path


def frame_matching_segments(frame0_width: int, positions0: np.ndarray,
                            positions1: np.ndarray, pairs: Sequence,
                            gap: int = 20) -> list:
    """The lines of ``plot_frame_matching``: for each pair, ((x0, x1),
    (y0, y1)) in the side-by-side canvas, as the JAX figure plots them."""
    off = frame0_width + gap
    return [((positions0[i][1], positions1[j][1] + off),
             (positions0[i][0], positions1[j][0])) for i, j in pairs]


def plot_frame_matching(frame0: np.ndarray, frame1: np.ndarray,
                        positions0: np.ndarray, positions1: np.ndarray,
                        pairs: Sequence, path: str) -> str:
    """Two frames side by side with lines joining matched centroids
    (Fig 2 C1, reference plottings.py:260-354), pair k in tab10 colour
    k % 10, each end a dot.

    pairs: sequence of (i0, i1) index pairs into positions0/positions1.
    """
    f0, f1 = _to_rgb_u8(frame0), _to_rgb_u8(frame1)
    h = max(f0.shape[0], f1.shape[0])
    gap = 20
    canvas = np.full((h, f0.shape[1] + gap + f1.shape[1], 3), 255, np.uint8)
    canvas[:f0.shape[0], :f0.shape[1]] = f0
    canvas[:f1.shape[0], f0.shape[1] + gap:] = f1
    segments = frame_matching_segments(f0.shape[1], positions0, positions1,
                                       pairs, gap)
    for k, (xs, ys) in enumerate(segments):
        colour = tuple(int(v) for v in _tab10(k % 10))
        p, q = (int(round(xs[0])), int(round(ys[0]))), \
            (int(round(xs[1])), int(round(ys[1])))
        line(canvas, p, q, colour, 2)
        for x, y in (p, q):
            _circle(canvas, x, y, 3, np.asarray(colour, np.uint8))
    write_png(path, canvas[..., ::-1])
    return path


def plot_trajectory_on_frame(frame: np.ndarray, positions: np.ndarray,
                             path: str, color=(53, 52, 205),
                             thickness: int = 2,
                             origin: Optional[np.ndarray] = None) -> str:
    """Draw a trajectory's path as line segments over its first frame
    (Fig 4 B, reference plottings.py:897-924), cv2's thick lines.

    positions: (T, 2) (y, x) centroids; origin: top-left of the frame crop in
    stack coordinates (defaults to positions[0] - frame_center).
    """
    mat = _to_rgb_u8(frame)
    positions = np.asarray(positions, np.int64)
    if origin is None:
        origin = positions[0] - np.array([mat.shape[0] // 2,
                                          mat.shape[1] // 2])
    rel = positions - np.asarray(origin)
    for i in range(len(rel) - 1):
        line(mat, (int(rel[i][1]), int(rel[i][0])),
             (int(rel[i + 1][1]), int(rel[i + 1][0])),
             tuple(int(v) for v in color), thickness)
    write_png(path, mat)
    return path


# ---------------------------------------------------------------------------
# Embedding figures
# ---------------------------------------------------------------------------

def embedding_points(embedding: np.ndarray, labels=None, values=None,
                     zoom_cutoff: float = 1.0, cmap: str = "Paired",
                     dims=(0, 1)):
    """What ``plot_embedding_scatter`` draws: (x, y, (N, 3) uint8 RGB
    colours, filled, xlim, ylim). ``values`` or ``labels`` map through
    ``cmap`` over their range (matplotlib's ``c=..., cmap=...``), labels as
    hollow markers; neither gives every point tab10's first colour. The
    limits are the ``zoom_cutoff`` percentiles (``zoom_axis``)."""
    emb = np.asarray(embedding)
    x, y = emb[:, dims[0]], emb[:, dims[1]]
    if values is not None:
        colours, filled = map_colours(values, cmap), True
    elif labels is not None:
        colours, filled = map_colours(labels, cmap), False
    else:
        colours, filled = np.repeat(colormap_lut("tab10")[:1], len(x), 0), True
    xlim, ylim = zoom_limits(x, y, zoom_cutoff)
    return x, y, colours, filled, xlim, ylim


def _marker_radius(s: float) -> float:
    """A scatter marker's radius in px: area ``s`` pt^2 at DPI."""
    return float(np.sqrt(s) / 2 * DPI / 72)


def plot_embedding_scatter(embedding: np.ndarray, path: str,
                           labels: Optional[np.ndarray] = None,
                           conditions: Optional[Sequence[str]] = None,
                           values: Optional[np.ndarray] = None,
                           zoom_cutoff: float = 1.0, cmap: str = "Paired",
                           xlabel: str = "PC 1", ylabel: str = "PC 2",
                           dims=(0, 1), s: float = 7.0,
                           alpha: float = 0.1) -> str:
    """PCA/UMAP scatter, colored by condition labels or continuous values
    (reference plotting_cm.py:40-93 per-condition scatter; plottings.py:
    487-541 continuous size coloring with BuPu cmap), in the zoomed limits
    (``embedding_points``). ``conditions``, ``xlabel`` and ``ylabel`` are
    text: not drawn."""
    x, y, colours, filled, xlim, ylim = embedding_points(
        embedding, labels, values, zoom_cutoff, cmap, dims)
    img = scatter_panel(x, y, colours, xlim, ylim, filled=filled,
                        alpha=alpha, radius=_marker_radius(s))
    write_rgb_png(path, img)
    return path


def explained_variance_curve(explained_variance_ratio: np.ndarray):
    """(number of PCs, cumulative explained variance), as plotted."""
    r = np.asarray(explained_variance_ratio)
    return np.arange(1, len(r) + 1), np.cumsum(r)


def plot_explained_variance(explained_variance_ratio: np.ndarray,
                            path: str) -> str:
    """Cumulative explained variance vs number of PCs (Supp Fig 6,
    reference plottings.py:451-464): dots joined by a line, y from 0 to 1,
    x autoscaled as matplotlib does."""
    x, y = explained_variance_curve(explained_variance_ratio)
    img = _blank()
    rows, cols = _to_px(x, y, _autoscale(x), (0.0, 1.0))
    _polyline(img, rows, cols, _tab10(0))
    for r, c in zip(np.rint(rows).astype(int), np.rint(cols).astype(int)):
        _circle(img, c, r, 6, _tab10(0).astype(np.float32))
    draw_frame(img)
    write_rgb_png(path, img)
    return path


def pc_property_values(pc_values: np.ndarray, prop: np.ndarray,
                       log_prop: bool = False):
    """(x, y) of ``plot_pc_vs_property``: the property's log if asked."""
    p = np.log(np.asarray(prop)) if log_prop else np.asarray(prop)
    return np.asarray(pc_values), p


def plot_pc_vs_property(pc_values: np.ndarray, prop: np.ndarray, path: str,
                        xlabel: str = "PC 1", ylabel: str = "property",
                        log_prop: bool = False, density: bool = False) -> str:
    """Scatter (or 2-D histogram density) of a PC against a morphology
    property (Supp Fig 2, reference plottings.py:594-634). The density is
    ``np.histogram2d`` at 40 bins a side, as ``hist2d`` counts it, in
    Blues over the counts' range, with a colour bar. Labels not drawn."""
    x, p = pc_property_values(pc_values, prop, log_prop)
    if density:
        counts, xe, ye = np.histogram2d(x, p, bins=40)
        h, w = PANEL[0] - 2 * MARGIN, PANEL[1] - 2 * MARGIN - 2 * BAR
        # rows top to bottom are y bins high to low
        ci = np.minimum((np.arange(w) * 40) // w, 39)
        ri = 39 - np.minimum((np.arange(h) * 40) // h, 39)
        img = _blank()
        img[MARGIN:MARGIN + h, MARGIN:MARGIN + w] = map_colours(
            counts, "Blues")[ci[None, :], ri[:, None]]
        img[MARGIN:MARGIN + h, PANEL[1] - MARGIN - BAR:PANEL[1] - MARGIN] = \
            _colour_bar("Blues", h)
    else:
        c0 = colormap_lut("tab10")[:1]
        img = scatter_panel(x, p, np.repeat(c0, len(x), 0),
                            _autoscale(x), _autoscale(p), filled=True,
                            alpha=0.2, radius=_marker_radius(5))
    draw_frame(img)
    write_rgb_png(path, img)
    return path


def correlation_matrix(components: np.ndarray,
                       properties: Dict[str, np.ndarray],
                       n_components: int = 6) -> np.ndarray:
    """(n PCs, n properties) Pearson correlations, ``np.corrcoef`` pair by
    pair as the JAX figure computes them."""
    comp = np.asarray(components)[:, :n_components]
    names = list(properties)
    mat = np.zeros((comp.shape[1], len(names)))
    for j, name in enumerate(names):
        v = np.asarray(properties[name], np.float64)
        for i in range(comp.shape[1]):
            mat[i, j] = np.corrcoef(comp[:, i], v)[0, 1]
    return mat


def plot_correlation_matrix(components: np.ndarray,
                            properties: Dict[str, np.ndarray],
                            path: str, n_components: int = 6) -> str:
    """Pearson-correlation heatmap between leading PCs and morphology
    properties (Supp Fig 4, reference plottings.py:746-791): one 80 px
    cell a pair in coolwarm over [-1, 1] and a colour bar; the names and
    the printed values are not drawn."""
    mat = correlation_matrix(components, properties, n_components)
    cell = 80
    h, w = mat.shape[0] * cell, mat.shape[1] * cell
    img = np.full((h, w + GAP + BAR, 3), 255, np.uint8)
    img[:, :w] = np.repeat(np.repeat(
        map_colours(mat, "coolwarm", -1.0, 1.0), cell, 0), cell, 1)
    img[:, w + GAP:] = _colour_bar("coolwarm", h)
    write_png(path, img[..., ::-1])
    return path


# ---------------------------------------------------------------------------
# Density figures
# ---------------------------------------------------------------------------

def _fit_kde(data):
    """seaborn's ``KDE._fit``: scipy's Gaussian KDE at Scott's bandwidth,
    the bandwidth set again at its factor times bw_adjust = 1."""
    from scipy.stats import gaussian_kde

    kde = gaussian_kde(data, bw_method=None)
    kde.set_bandwidth(kde.factor * 1)
    return kde


def _grid(x, bw: float, gridsize: int = 200, cut: float = 3.0):
    return np.linspace(x.min() - bw * cut, x.max() + bw * cut, gridsize)


def kde_curve(values: np.ndarray):
    """(support, density) of seaborn's univariate ``kdeplot`` at its
    defaults: 200 points, cut 3 bandwidths past the data."""
    x = np.asarray(values)
    x = x[~np.isnan(x)]
    kde = _fit_kde(x)
    support = _grid(x, np.sqrt(kde.covariance.squeeze()))
    return support, kde(support)


def joint_kde(x: np.ndarray, y: np.ndarray):
    """seaborn's bivariate ``kdeplot(fill=True)`` at its defaults:
    (x support, y support, density (200, 200) indexed [y, x], the ten
    contour levels of iso-proportions linspace(0.05, 1, 10))."""
    x1, x2 = np.asarray(x), np.asarray(y)
    kde = _fit_kde([x1, x2])
    bw = np.sqrt(np.diag(kde.covariance).squeeze())
    support = _grid(x1, bw[0]), _grid(x2, bw[1])
    xx1, xx2 = np.meshgrid(*support)
    density = kde([xx1.ravel(), xx2.ravel()]).reshape(xx1.shape)
    # seaborn's _quantile_to_level
    isoprop = np.linspace(0.05, 1, 10)
    sorted_values = np.sort(np.ravel(density))[::-1]
    normalized = np.cumsum(sorted_values) / np.ravel(density).sum()
    levels = np.take(sorted_values,
                     np.searchsorted(normalized, 1 - isoprop), mode="clip")
    return support[0], support[1], density, levels


def violin_stats(groups: Sequence[np.ndarray], points: int = 100) -> list:
    """matplotlib's ``violin_stats`` with its Gaussian KDE at Scott's
    bandwidth: per group {coords (``points`` from min to max), vals,
    mean, median, min, max}."""
    from scipy.stats import gaussian_kde

    out = []
    for x in groups:
        x = np.asarray(x)
        coords = np.linspace(np.min(x), np.max(x), points)
        vals = (x[0] == coords).astype(float) if np.all(x[0] == x) \
            else gaussian_kde(x)(coords)
        out.append(dict(coords=coords, vals=vals, mean=np.mean(x),
                        median=np.median(x), min=np.min(x), max=np.max(x)))
    return out


def _fill_under(img, xs, ys, xlim, ylim, colour, alpha) -> None:
    """Fill between y = 0 and the curve (xs, ys), column by column."""
    h, w = PANEL
    cols = np.arange(MARGIN, w - MARGIN)
    data_x = xlim[0] + (cols - MARGIN) / (w - 2 * MARGIN - 1) * \
        (xlim[1] - xlim[0])
    inside = (data_x >= xs[0]) & (data_x <= xs[-1])
    top, _ = _to_px(0, np.interp(data_x, xs, ys), xlim, ylim)
    base, _ = _to_px(0, 0.0, xlim, ylim)
    rows = np.arange(h)[:, None]
    mask = np.zeros((h, w), bool)
    mask[:, cols] = (rows >= np.rint(top)[None, :]) & \
        (rows <= np.rint(base)) & inside[None, :]
    _blend(img, mask, colour, alpha)


def plot_distribution_comparison(values_subset: np.ndarray,
                                 values_all: np.ndarray, path: str,
                                 xlabel: str = "PC 1",
                                 labels=("in trajectories", "all")) -> str:
    """Overlaid density estimates of a quantity inside trajectories vs the
    whole dataset (Supp Fig 5, reference plottings.py:795-833): each
    ``kde_curve`` filled at alpha 0.3 (tab10's first and second colours)
    with its outline. The legend and labels are not drawn."""
    curves = [kde_curve(values_subset), kde_curve(values_all)]
    xlim = _autoscale(np.concatenate([s for s, _ in curves]))
    ylim = (0.0, max(float(d.max()) for _, d in curves) * (1 + MPL_MARGIN))
    img = _blank()
    for (support, density), colour in zip(curves, (_tab10(0), _tab10(1))):
        _fill_under(img, support, density, xlim, ylim, colour, 0.3)
        rows, cols = _to_px(support, density, xlim, ylim)
        _polyline(img, rows, cols, colour, 2)
    draw_frame(img)
    write_rgb_png(path, img)
    return path


def plot_joint_kde(x: np.ndarray, y: np.ndarray, path: str,
                   xlabel: str = "PC 1", ylabel: str = "log speed",
                   xlim=None, ylim=None) -> str:
    """Joint KDE with marginal histograms (Fig 4 A, reference
    plottings.py:837-893): the filled contours of ``joint_kde`` (the band
    between two levels in Blues at its midpoint, over the levels' range,
    as ``contourf`` colours it), 20-bin histograms of x above and of y to
    the right. ``xlim`` / ``ylim`` default to the density's support."""
    gx, gy, density, levels = joint_kde(x, y)
    xlim = (gx[0], gx[-1]) if xlim is None else xlim
    ylim = (gy[0], gy[-1]) if ylim is None else ylim
    size = (PANEL[0], PANEL[0])
    img = _blank(size)
    h, w = size
    rows = np.arange(MARGIN, h - MARGIN)
    cols = np.arange(MARGIN, w - MARGIN)
    data_y = ylim[1] - (rows - MARGIN) / (h - 2 * MARGIN - 1) * \
        (ylim[1] - ylim[0])
    data_x = xlim[0] + (cols - MARGIN) / (w - 2 * MARGIN - 1) * \
        (xlim[1] - xlim[0])
    iy = np.rint((data_y - gy[0]) / (gy[-1] - gy[0]) * (len(gy) - 1))
    ix = np.rint((data_x - gx[0]) / (gx[-1] - gx[0]) * (len(gx) - 1))
    ok = (iy[:, None] >= 0) & (iy[:, None] < len(gy)) & \
        (ix[None, :] >= 0) & (ix[None, :] < len(gx))
    z = density[np.clip(iy, 0, len(gy) - 1).astype(int)[:, None],
                np.clip(ix, 0, len(gx) - 1).astype(int)[None, :]]
    # contourf's bands: levels[i] < z <= levels[i + 1]
    band = np.searchsorted(levels, z, side="left") - 1
    layers = 0.5 * (levels[:-1] + levels[1:])
    colours = map_colours(layers, "Blues", levels[0], levels[-1])
    sub = img[MARGIN:h - MARGIN, MARGIN:w - MARGIN]
    for b, colour in enumerate(colours):
        sub[ok & (band == b)] = colour
    draw_frame(img)
    top = _histogram_strip(x, xlim, w, vertical=False)
    right = _histogram_strip(y, ylim, h, vertical=True)
    out = np.full((h + top.shape[0], w + right.shape[1], 3), 255.0,
                  np.float32)
    out[top.shape[0]:, :w] = img
    out[:top.shape[0], :w] = top
    out[top.shape[0]:, w:] = right
    write_rgb_png(path, out)
    return path


def _histogram_strip(v, lim, length: int, vertical: bool,
                     depth: int = 240) -> np.ndarray:
    """A marginal histogram (20 bins, ``np.histogram``) along a panel's
    side, its bars in tab10's first colour."""
    counts, edges = np.histogram(np.asarray(v), bins=20)
    strip = np.full((length, depth, 3), 255.0, np.float32)
    pos = np.arange(length)
    data = lim[0] + (pos - MARGIN) / (length - 2 * MARGIN - 1) * \
        (lim[1] - lim[0])
    if vertical:
        data = data[::-1]
    idx = np.searchsorted(edges, data, side="right") - 1
    idx[data == edges[-1]] = len(counts) - 1
    inside = (idx >= 0) & (idx < len(counts)) & (pos >= MARGIN) & \
        (pos < length - MARGIN)
    bar = np.where(inside, counts[np.clip(idx, 0, len(counts) - 1)], 0)
    fill = np.arange(depth)[None, :] < np.rint(
        bar / max(counts.max(), 1) * (depth - 20))[:, None]
    strip[fill] = _tab10(0)
    return strip if vertical else strip.transpose(1, 0, 2)[::-1]


def plot_violin_modes(groups: Dict[str, np.ndarray], path: str,
                      ylabel: str = "average displacement") -> str:
    """Violin plot comparing per-mode distributions (Fig 4 C, reference
    plottings.py:934-963): ``violinplot(showmedians=True)`` at positions
    1..n, width 0.5: each ``violin_stats`` density mirrored about its
    position (scaled to half the width at its peak) filled at alpha 0.3,
    the extrema and median bars a quarter width a side and the vertical
    bar between the extrema. The names and label are not drawn."""
    names = list(groups)
    stats = violin_stats([np.asarray(groups[n]) for n in names])
    xlim = (0.5, len(names) + 0.5)
    ylim = _autoscale(np.concatenate([s["coords"] for s in stats]))
    img = _blank()
    h, w = PANEL
    rows = np.arange(MARGIN, h - MARGIN)
    data_y = ylim[1] - (rows - MARGIN) / (h - 2 * MARGIN - 1) * \
        (ylim[1] - ylim[0])
    cols = np.arange(w)
    for k, s in enumerate(stats):
        pos = k + 1.0
        half = 0.5 * 0.5 * s["vals"] / s["vals"].max()
        inside = (data_y >= s["coords"][0]) & (data_y <= s["coords"][-1])
        width = np.where(inside, np.interp(data_y, s["coords"], half), -1.0)
        _, c_lo = _to_px(pos - width, 0, xlim, ylim)
        _, c_hi = _to_px(pos + width, 0, xlim, ylim)
        mask = np.zeros((h, w), bool)
        mask[rows] = (cols[None, :] >= np.rint(c_lo)[:, None]) & \
            (cols[None, :] <= np.rint(c_hi)[:, None]) & inside[:, None]
        _blend(img, mask, _tab10(0), 0.3)
        for yv in (s["min"], s["max"], s["median"]):
            r, c = _to_px([pos - 0.125, pos + 0.125], [yv, yv], xlim, ylim)
            _polyline(img, r, c, _tab10(0), 2)
        r, c = _to_px([pos, pos], [s["min"], s["max"]], xlim, ylim)
        _polyline(img, r, c, _tab10(0), 2)
    draw_frame(img)
    write_rgb_png(path, img)
    return path


def force_aspect(ax, aspect: float = 1.0) -> float:
    """The display aspect the JAX package's ``force_aspect`` sets on a
    matplotlib Axes (reference plottings.py forceAspect /
    B4_temp.py:9-12): the port has no Axes, so ``ax`` is the pair
    ``(xlim, ylim)`` of the panel's limits and the ratio
    ``|(xmax - xmin) / (ymax - ymin)| / aspect`` is returned."""
    (xmin, xmax), (ymin, ymax) = ax
    return abs((xmax - xmin) / (ymax - ymin)) / aspect
