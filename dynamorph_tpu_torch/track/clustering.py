"""Instance segmentation: foreground clustering of semantic-segmentation
maps, the port of ``dynamorph_tpu/track/clustering.py`` (reference
SingleCellPatch/instance_clustering.py:20-182).

Foreground = mean background probability < fg_thr; DBSCAN(eps=10,
min_samples=250) over the foreground pixel coordinates (the native grid
solver, native/grid_dbscan.cpp); size filter (500, 12000) px; cells with
more than 5% of their pixels outside the 256 x 256 window around their mean
are dropped. It runs on the host, as in the JAX package.

The instance-map PNG differs from the JAX package's matplotlib figure: it
is the frame-sized label image, each kept cell in ``tab10[id % 10]``, all
else black, with no id text (io/png.py; the card's machine has no
matplotlib).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..io.pickles import save_pickle
from ..io.png import write_png

# Frames with fewer foreground pixels than this early-out with no cells and
# no instance-map PNG (reference instance_clustering.py:69-70).
MIN_FG_PIXELS = 1000

# matplotlib's "tab10" colours (RGB), the colours of the JAX package's
# instance maps
TAB10 = np.array([
    [31, 119, 180], [255, 127, 14], [44, 160, 44], [214, 39, 40],
    [148, 103, 189], [140, 86, 75], [227, 119, 194], [127, 127, 127],
    [188, 189, 34], [23, 190, 207]], dtype=np.uint8)


def check_segmentation_dim(segmentation: np.ndarray) -> np.ndarray:
    """Ensure (n_classes, z, x, y); add a background channel to binary
    masks (reference instance_clustering.py:39-55)."""
    if segmentation.ndim != 4:
        raise ValueError("Semantic segmentation should be formatted with "
                         "dimension (c, z, x, y)")
    if segmentation.shape[0] == 1:
        segmentation = np.concatenate([1 - segmentation, segmentation],
                                      axis=0)
    if not np.allclose(segmentation.sum(0), 1.0):
        raise ValueError("Semantic segmentation doesn't sum up to 1")
    return segmentation


def instance_clustering(cell_segmentation: np.ndarray,
                        ct_thr: Tuple[int, int] = (500, 12000),
                        instance_map: bool = True,
                        map_path: Optional[str] = None,
                        fg_thr: float = 0.3,
                        dbscan_thr: Tuple[int, int] = (10, 250)):
    """Cluster the foreground pixels of one frame into cell instances
    (reference instance_clustering.py:58-137).

    Returns (cell_positions [(id, centre)...], foreground pixel coordinates
    (N, 2) int64 in row-major order, per-pixel labels (N,) int32).
    """
    cell_segmentation = check_segmentation_dim(cell_segmentation)
    all_cells = np.mean(cell_segmentation[0], axis=0) < fg_thr
    positions = np.argwhere(all_cells)
    return cluster_foreground_positions(
        positions, cell_segmentation.shape[-2:], ct_thr=ct_thr,
        instance_map=instance_map, map_path=map_path, dbscan_thr=dbscan_thr)


def cluster_foreground_positions(positions: np.ndarray,
                                 shape: Tuple[int, int],
                                 ct_thr: Tuple[int, int] = (500, 12000),
                                 instance_map: bool = True,
                                 map_path: Optional[str] = None,
                                 dbscan_thr: Tuple[int, int] = (10, 250),
                                 threads: Optional[int] = None):
    """DBSCAN and the size and window filters over precomputed foreground
    pixel coordinates (row-major, as ``np.argwhere`` yields them)
    (reference instance_clustering.py:58-137 after the threshold).

    ``threads`` caps the native solver's core-test threads (None:
    ``grid_dbscan``'s default; the labels are identical for any count): the
    fused stage, which clusters several frames at once, divides the cores
    among them."""
    from ..native.dbscan import grid_dbscan

    if len(positions) < MIN_FG_PIXELS:
        return [], np.zeros((0, 2), dtype=int), np.zeros((0,), dtype=int)

    positions_labels = grid_dbscan(positions, eps=dbscan_thr[0],
                                   min_samples=dbscan_thr[1], shape=shape,
                                   threads=threads)
    cell_ids, point_cts = np.unique(positions_labels, return_counts=True)

    cell_positions = []
    for cell_id, ct in zip(cell_ids, point_cts):
        if cell_id < 0:
            continue  # noise
        if ct <= ct_thr[0] or ct >= ct_thr[1]:
            continue  # too small / too big
        points = positions[positions_labels == cell_id]
        mean_pos = np.mean(points, 0).astype(int)
        # the reference's per-pixel within_range loop
        # (instance_clustering.py:113), vectorised over the cluster
        lo = mean_pos - 128
        hi = mean_pos + 128
        n_outliers = int(np.sum(np.any((points < lo) | (points >= hi),
                                       axis=1)))
        if n_outliers > len(points) * 0.05:
            continue
        cell_positions.append((cell_id, mean_pos))

    if instance_map and map_path is not None:
        save_instance_map(cell_positions, positions, positions_labels,
                          shape, map_path)
    return cell_positions, positions, positions_labels


def save_instance_map(cell_positions, positions, positions_labels,
                      shape, map_path: str) -> None:
    """The instance-map PNG (reference instance_clustering.py:119-136): an
    (H, W) colour image, each kept cell's pixels in ``TAB10[id % 10]``,
    everything else black."""
    image = np.zeros(tuple(shape) + (3,), np.uint8)
    for cell_id, _ in cell_positions:
        pts = positions[positions_labels == cell_id]
        image[pts[:, 0], pts[:, 1]] = TAB10[cell_id % 10][::-1]   # BGR
    write_png(map_path, image)


def process_site_instance_segmentation(raw_data: str,
                                       raw_data_segmented: str,
                                       site_supp_files_folder: str
                                       ) -> None:
    """Per-site instance segmentation (reference
    instance_clustering.py:140-182). Saves cell_positions.pkl,
    cell_pixel_assignments.pkl and one instance-map PNG per frame."""
    n_frames = np.load(raw_data, mmap_mode="r").shape[0]
    segmentation_stack = np.load(raw_data_segmented)
    os.makedirs(site_supp_files_folder, exist_ok=True)

    cell_positions: Dict[int, list] = {}
    cell_pixel_assignments: Dict[int, tuple] = {}
    for t_point in range(n_frames):
        cell_segmentation = segmentation_stack[t_point]
        map_path = os.path.join(site_supp_files_folder,
                                "segmentation_%d.png" % t_point)
        res = instance_clustering(cell_segmentation, instance_map=True,
                                  map_path=map_path)
        cell_positions[t_point] = res[0]
        cell_pixel_assignments[t_point] = res[1:]
    save_pickle(cell_positions,
                os.path.join(site_supp_files_folder, "cell_positions.pkl"))
    save_pickle(cell_pixel_assignments,
                os.path.join(site_supp_files_folder,
                             "cell_pixel_assignments.pkl"))
