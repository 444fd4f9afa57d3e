"""Semantic segmentation pipeline stage — the port of ``segmentation`` in
``dynamorph_tpu/pipeline/segmentation.py`` (reference
pipeline/segmentation.py:13-87).

For each site, ``<raw>/<site>.npy`` goes through the U-Net on the card and
``<site>_NNProbabilities.npy``, ``<site>.png`` and ``<site>_NNpred.png`` are
written beside it. ``segmentation_validation`` draws the clustered cells'
rims onto the raw frames, and ``segmentation_validation_contours`` /
``validation_pngs_to_tiff`` the edges of the instance maps onto resized
frames (host work; PNGs through ``io/png.py``, the uint8 resize of
``ops/geometry.py``).
"""
from __future__ import annotations

import logging
import os
from typing import Sequence, Union

import numpy as np
import torch

from ..core.profiling import stage_timer
from ..io.pickles import load_pickle
from ..io.png import read_png, write_png
from ..io.sites import site_supp_folder
from ..io.tiff import write_multipage_tiff
from ..ops.geometry import resize
from ..seg.inference import predict_whole_map
from ..seg.model import Segment, SegmentWithMultipleSlice

log = logging.getLogger(__name__)


def segmentation(raw_folder: str, supp_folder: str, val_folder: str,
                 sites: Sequence[str], config,
                 device: Union[str, torch.device] = "cuda") -> None:
    """Semantic segmentation over sites: loads the U-Net weights
    (``segmentation_inference.weights``, a model.pt or a directory holding
    one), predicts each site's stack in ``inference_mode`` ("tiled" or
    "direct") and saves the probabilities and preview PNGs.

    A site that fails is logged ("Error in predicting site <site>", with the
    traceback) and the loop goes on, as the reference does (:76-86).
    """
    si = config.segmentation_inference
    if si.network != "UNet":
        raise NotImplementedError(
            f"segmentation model {si.network} not implemented")
    if si.time_slices > 1:
        model = SegmentWithMultipleSlice(
            unet_feat=si.unet_feat,
            input_shape=(len(si.channels), si.time_slices, si.window_size,
                         si.window_size),
            n_classes=si.num_classes, device=device)
    else:
        model = Segment(input_shape=(len(si.channels), si.window_size,
                                     si.window_size),
                        n_classes=si.num_classes, device=device)
    if not si.weights:
        raise ValueError("segmentation weights path must be provided")
    try:
        model.load(si.weights)
    except Exception as ex:
        log.error(ex)
        raise ValueError("Error in loading UNet weights") from ex

    for site in sites:
        site_path = os.path.join(raw_folder, f"{site}.npy")
        if not os.path.exists(site_path):
            log.info("Site not found %s", site_path)
            continue
        log.info("Predicting %s", site_path)
        try:
            with stage_timer("segmentation", site=site):
                predict_whole_map(
                    site_path, model,
                    use_channels=np.array(si.channels).astype(int),
                    batch_size=si.batch_size,
                    n_supp=si.num_pred_rnd, mode=si.inference_mode,
                    time_slices=si.time_slices)
        except Exception:  # per-site failure tolerance (reference :76-86)
            log.exception("Error in predicting site %s", site)


def segmentation_validation(raw_folder: str, supp_folder: str,
                            val_folder: str, sites: Sequence[str],
                            config) -> None:
    """Each cell's rim drawn onto the raw frames, green for a non-MG cell
    and red for an MG one, as one multipage uint16 RGB TIFF a site:
    ``<supp>/validation_images/<site>_predictions.tif`` (``segmentation_
    validation``, dynamorph_tpu/pipeline/segmentation.py:61-118; reference
    pipeline/segmentation_validation.py:67-168). Host work: it reads the
    site's stack, ``_NNProbabilities.npy`` and instance pickles.

    ``segmentation_inference.seg_val_cat``: "mg", "nonmg" or "both" draw
    the kept cells of that class (classified from the probabilities, as the
    JAX package does: the reference's filters read a cell_positions layout
    the pipeline no longer writes); "unfiltered" draws every cluster.
    """
    category = config.segmentation_inference.seg_val_cat
    target = os.path.join(supp_folder, "validation_images")
    os.makedirs(target, exist_ok=True)
    for site in sites:
        raw_stack = np.load(os.path.join(raw_folder, f"{site}.npy"))
        nn_stack = np.load(os.path.join(raw_folder,
                                        f"{site}_NNProbabilities.npy"))
        supp = site_supp_folder(supp_folder, site)
        cell_pixels = load_pickle(
            os.path.join(supp, "cell_pixel_assignments.pkl"))
        cell_positions = load_pickle(os.path.join(supp, "cell_positions.pkl"))

        stack = []
        for t_point in range(len(raw_stack)):
            mat = raw_stack[t_point, 0, 0] if raw_stack.ndim == 5 \
                else raw_stack[t_point, :, :, 0]
            mat = np.stack([mat] * 3, 2)
            positions, inds = cell_pixels[t_point]
            if category == "unfiltered":
                ids = [i for i in np.unique(inds) if i >= 0]
            else:
                ids = []
                for cid, _ in cell_positions[t_point]:
                    pts = positions[inds == cid]
                    probs = nn_stack[t_point][
                        :, 0, pts[:, 0], pts[:, 1]].mean(1)
                    # classes (background, non-MG, MG): MG when class 2
                    # outweighs class 1, as the rim colours say
                    is_mg = probs[2] > probs[1]
                    if category == "both" or \
                            (category == "mg" and is_mg) or \
                            (category == "nonmg" and not is_mg):
                        ids.append(cid)
            for cid in ids:
                new_mat = _append_segmentation(positions, inds, cid,
                                               nn_stack, t_point, mat)
                if new_mat is not None:
                    mat = new_mat
            stack.append(mat)

        out = os.path.join(target, f"{site}_predictions.tif")
        write_multipage_tiff(out, np.stack(stack, 0).astype("uint16"))
        log.info("saved validation overlay %s", out)


def find_rim(cell_positions: np.ndarray) -> np.ndarray:
    """The boundary pixels of a pixel set: those without all four
    neighbours in it (reference segmentation_validation.py:10-17)."""
    masks = set(tuple(r) for r in cell_positions)
    inner = set((r[0] - 1, r[1]) for r in masks) & \
        set((r[0] + 1, r[1]) for r in masks) & \
        set((r[0], r[1] - 1) for r in masks) & \
        set((r[0], r[1] + 1) for r in masks)
    return np.array(list(masks - inner))


def _append_segmentation(positions, inds, cell_id, nn_stack, t_point, mat):
    """Draw one cell's rim onto ``mat`` (H, W, 3), green for non-MG and red
    for MG (reference segmentation_validation.py:171-195); None for noise.
    ``nn_stack`` is (T, n_classes, 1, H, W)."""
    if cell_id < 0:
        return None
    pts = positions[inds == cell_id]
    rim = find_rim(pts)
    mask_identities = nn_stack[t_point][:, 0, pts[:, 0], pts[:, 1]].mean(1)
    if mask_identities[1] > mask_identities[2]:
        mat[(rim[:, 0], rim[:, 1])] = np.array([0, 65535, 0]).reshape((1, 3))
    else:
        mat[(rim[:, 0], rim[:, 1])] = np.array([65535, 0, 0]).reshape((1, 3))
    return mat


def draw_contour_overlay(phase: np.ndarray, seg: np.ndarray,
                         threshold: float = 30.0,
                         color=(255, 0, 0)) -> np.ndarray:
    """Paint the edges of a segmentation map onto a grayscale frame in
    ``color`` (reference segmentation_validation.py:20-34, :57-63): ``seg``
    thresholded at ``threshold``, an edge pixel a mask pixel with an
    off-mask pixel among its 8 neighbours. Returns (H, W, 3) uint8 RGB."""
    mask = np.asarray(seg) > threshold
    interior = np.ones_like(mask)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr == 0 and dc == 0:
                continue
            shifted = np.zeros_like(mask)
            rs = slice(max(dr, 0), mask.shape[0] + min(dr, 0))
            rd = slice(max(-dr, 0), mask.shape[0] + min(-dr, 0))
            cs = slice(max(dc, 0), mask.shape[1] + min(dc, 0))
            cd = slice(max(-dc, 0), mask.shape[1] + min(-dc, 0))
            shifted[rd, cd] = mask[rs, cs]
            interior &= shifted
    edges = mask & ~interior
    phase = np.asarray(phase)
    if phase.ndim == 2:
        if phase.dtype == np.uint8:
            rgb = np.stack([phase] * 3, axis=2)
        else:
            # min-max scale to [0, 255]: float frames may be z-scored
            lo, hi = float(phase.min()), float(phase.max())
            scaled = np.clip((phase - lo) / max(hi - lo, 1e-12) * 255,
                             0, 255)
            rgb = np.stack([scaled] * 3, axis=2).astype(np.uint8)
    else:
        rgb = np.clip(phase, 0, 255).astype(np.uint8).copy()
    rgb[edges] = np.asarray(color, np.uint8)
    return rgb


def segmentation_validation_contours(raw_folder: str, supp_folder: str,
                                     val_folder: str, sites: Sequence[str],
                                     out_size=(1108, 1108)) -> None:
    """Per-frame contour-overlay PNGs: each ``segmentation_<t>.png``
    instance map's edges drawn onto the min-max scaled phase frame, both
    resized to ``out_size`` (the frame bilinear, the map nearest), as
    ``<val_folder>/<site>_<t>.png`` (reference
    segmentation_validation.py:196-233). A frame without its map is
    skipped with a warning."""
    os.makedirs(val_folder, exist_ok=True)
    for site in sites:
        raw_stack = np.load(os.path.join(raw_folder, f"{site}.npy"))
        seg_dir = site_supp_folder(supp_folder, site)
        log.info("building full frame validation for %s", site)
        for t_point in range(len(raw_stack)):
            seg_path = os.path.join(seg_dir, f"segmentation_{t_point}.png")
            if not os.path.exists(seg_path):
                log.warning("missing %s; skipping frame", seg_path)
                continue
            seg = read_png(seg_path, "gray")
            phase = raw_stack[t_point, 0, 0] if raw_stack.ndim == 5 \
                else raw_stack[t_point, :, :, 0]
            lo, hi = float(phase.min()), float(phase.max())
            phase8 = (np.clip((phase - lo) / max(hi - lo, 1e-12), 0, 1)
                      * 255).astype(np.uint8)
            if out_size:
                phase8 = resize(phase8, tuple(out_size), "linear")
                seg = resize(seg, tuple(out_size), "nearest")
            overlay = draw_contour_overlay(phase8, seg)
            write_png(os.path.join(val_folder, f"{site}_{t_point}.png"),
                      overlay[:, :, ::-1])           # RGB -> BGR


def validation_pngs_to_tiff(val_folder: str, site: str,
                            out_path: str = None) -> str:
    """Stack a site's per-frame validation PNGs, in frame order, into one
    multipage uint16 RGB TIFF (x 257), ``<site>_composite.tif`` by default
    (reference segmentation_validation.py:235-264)."""
    import re

    pat = re.compile(rf"^{re.escape(site)}_(\d+)\.png$")
    matched = sorted(
        (int(m.group(1)), f) for f in os.listdir(val_folder)
        if (m := pat.match(f)))
    if not matched:
        raise ValueError(f"no validation PNGs for site {site} in {val_folder}")
    frames = [read_png(os.path.join(val_folder, f), "color")[:, :, ::-1]
              for _, f in matched]
    stack = np.stack(frames, 0).astype(np.uint16) * 257
    out_path = out_path or os.path.join(val_folder, f"{site}_composite.tif")
    write_multipage_tiff(out_path, stack)
    return out_path
