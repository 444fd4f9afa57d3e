"""Instance segmentation, patch extraction and trajectory building stages,
the port of the staged half of ``dynamorph_tpu/pipeline/patch.py``
(reference pipeline/patch_VAE.py:22-112, pipeline/segmentation.py:90-141
and SingleCellPatch/extract_patches.py:156-278).

The per-cell window, mask and fill program of a frame (ops/patch.py) runs
on the card; DBSCAN, the LAP tracking and the pickle assembly run on the
host, as in the JAX package. The output is the reference's:
``stacks_<t>.pkl`` dicts of ``{"<supp>/<t>_<id>.h5": {"mat",
"masked_mat"}}``, float64 ``(C + 2, 1, window, window)``, with the target
and enlarged target masks as the last two channels.

Known reference bug not replicated: the reference indexes
``image_stack[channels]`` on axis 0 (time) instead of axis 1 (channel),
truncating frames (extract_patches.py:190-193); channels are selected on
axis 1.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..core.device import resolve_device, upload
from ..core.profiling import stage_timer
from ..io.compact import load_stack_any, resolve_any, save_stack, storage_path
from ..io.pickles import load_pickle, save_pickle
from ..io.prefetch import AsyncWriter
from ..io.sites import site_supp_folder
from ..native.contours import contour_area, find_contours, min_area_rect
from ..ops.geometry import rotation_matrix_2d, warp_affine
from ..ops.patch import extract_cell_patches, labels_to_map, median_background
from ..track.clustering import (check_segmentation_dim,
                                process_site_instance_segmentation)
from ..track.matching import build_site_trajectories

log = logging.getLogger(__name__)

Device = Union[str, torch.device]


def dispatch_cell_patches(raw, labels, bg_fill, kept_cells,
                          window_size: int = 256,
                          device: Device = "cuda") -> Optional[dict]:
    """Device half of a frame's patch extraction: the fused window, mask
    and fill program (ops/patch.py) over all ``kept_cells`` at once, on
    ``device``. Returns its tensors on the device (``None`` for no cell);
    ``fetch_cell_patches`` brings them to the host.

    ``raw``: (C, H, W) float32; ``labels``: (H, W) int32; ``bg_fill``: (C,)
    medians (arrays or tensors); ``kept_cells``: [(cell_id, centre)].
    """
    if not kept_cells:
        return None
    dev = torch.device(device)
    centers = np.array([(pos[0], pos[1]) for _, pos in kept_cells], np.int64)
    ids = np.array([int(cid) for cid, _ in kept_cells], np.int32)
    return extract_cell_patches(
        torch.as_tensor(raw, device=dev), torch.as_tensor(labels, device=dev),
        upload(centers, dev), upload(ids, dev),
        torch.as_tensor(bg_fill, device=dev), window_size=window_size)


def fetch_cell_patches(out: Optional[dict]) -> Optional[Dict[str, np.ndarray]]:
    """The device tensors of ``dispatch_cell_patches`` as host arrays
    (the masks travel as uint8)."""
    if out is None:
        return None
    return {k: v.cpu().numpy() for k, v in out.items()}


def assemble_site_data(out, kept_cells, site_supp_files_folder: str,
                       t_point: int, save_fig: bool = False
                       ) -> Dict[str, dict]:
    """Host half of a frame's patch extraction: the reference
    ``stacks_<t>.pkl`` layout (extract_patches.py:228-278) from the host
    arrays of ``fetch_cell_patches``. Pure numpy, so it can run on an
    io.prefetch.AsyncWriter thread."""
    site_data: Dict[str, dict] = {}
    if out is None or not kept_cells:
        return site_data
    mat, masked = out["mat"], out["masked_mat"]
    tm = out["tm"].astype(np.float32)
    tm2 = out["tm2"].astype(np.float32)
    for i, (cid, pos) in enumerate(kept_cells):
        cell_name = os.path.join(site_supp_files_folder,
                                 "%d_%d.h5" % (t_point, cid))
        # back to the (C(+2), Z, H, W) float64 layout
        m = np.concatenate(
            [mat[i][:, None], tm[i][None, None], tm2[i][None, None]],
            0).astype("float64")
        mm = np.concatenate(
            [masked[i][:, None], tm[i][None, None],
             tm2[i][None, None]], 0).astype("float64")
        site_data[cell_name] = {"mat": m, "masked_mat": mm}
        if save_fig:
            im_path = os.path.join(
                site_supp_files_folder,
                "patch_t%d_id%d.jpg" % (t_point, cid))
            save_single_cell_im(m[:, 0], mm[:, 0], tm[i], tm2[i], im_path)
    return site_data


def filter_boundary_cells(all_cells, half: int, x_size: int, y_size: int,
                          skip_boundary: bool):
    """Optionally drop cells whose window crosses the frame boundary
    (reference extract_patches.py:206-212)."""
    kept = list(all_cells)
    if skip_boundary:
        kept = [(cid, pos) for cid, pos in kept
                if pos[0] - half >= 0 and pos[0] + half <= x_size
                and pos[1] - half >= 0 and pos[1] + half <= y_size]
    return kept


def process_site_extract_patches(site_path: str, site_segmentation_path: str,
                                 site_supp_files_folder: str,
                                 window_size: int = 256,
                                 channels: Optional[Sequence[int]] = None,
                                 save_fig: bool = False, reload: bool = True,
                                 skip_boundary: bool = False,
                                 storage: str = "pickle",
                                 device: Device = "cuda") -> None:
    """Extract per-cell patches for every frame of one site
    (reference extract_patches.py:156-278).

    Per frame: the background median and the window, mask and fill
    program run on ``device``; the patch tensors come back to the host on
    this thread, and their assembly and write drain on an
    io.prefetch.AsyncWriter thread while the next frame runs. With
    ``reload``, frames whose stack exists (in either storage) and loads are
    skipped. ``cell_positions.pkl`` is saved again with the kept cells.

    ``storage="compact"`` writes float32 ``stacks_<t>.npz`` (io/compact.py)
    instead of the reference float64 pickles; the values are the same.
    """
    dev = resolve_device(device)
    image_stack = np.load(site_path)
    # channel selection on axis 1 (see the module docstring)
    if channels is not None:
        image_stack = image_stack[:, np.asarray(channels)]
    segmentation_stack = np.load(site_segmentation_path)
    cell_positions = load_pickle(
        os.path.join(site_supp_files_folder, "cell_positions.pkl"))
    cell_pixel_assignments = load_pickle(
        os.path.join(site_supp_files_folder, "cell_pixel_assignments.pkl"))

    n_frames, _, _, x_size, y_size = image_stack.shape
    half = window_size // 2
    with AsyncWriter(depth=2) as writer:
        for t_point in range(n_frames):
            stack_path = storage_path(
                os.path.join(site_supp_files_folder,
                             "stacks_%d.pkl" % t_point), storage)
            existing = resolve_any(stack_path)
            if reload and os.path.exists(existing):
                try:
                    load_stack_any(existing)
                    continue
                except Exception as e:
                    log.warning("failed reloading %s: %s", existing, e)
            cell_segmentation = check_segmentation_dim(
                segmentation_stack[t_point])
            positions, positions_labels = cell_pixel_assignments[t_point]
            kept_cells = filter_boundary_cells(cell_positions[t_point], half,
                                               x_size, y_size, skip_boundary)
            patches = None
            if kept_cells:
                # z squeezed
                raw = torch.from_numpy(
                    image_stack[t_point, :, 0].astype(np.float32)).to(dev)
                bg_prob = torch.from_numpy(
                    cell_segmentation[0, 0].astype(np.float32)).to(dev)
                bg_fill = median_background(raw, bg_prob)
                labels = labels_to_map((x_size, y_size), positions,
                                       positions_labels)
                patches = fetch_cell_patches(dispatch_cell_patches(
                    raw, labels, bg_fill, kept_cells,
                    window_size=window_size, device=dev))

            def assemble_and_save(out=patches, kept=kept_cells, t=t_point,
                                  path=stack_path):
                save_stack(
                    assemble_site_data(out, kept, site_supp_files_folder,
                                       t, save_fig=save_fig), path,
                    storage=storage)

            writer.submit(assemble_and_save)
            cell_positions[t_point] = kept_cells
    save_pickle(cell_positions,
                os.path.join(site_supp_files_folder, "cell_positions.pkl"))


def save_single_cell_im(output_mat, masked_output_mat, tm, tm2,
                        im_path: str) -> None:
    """4-panel patch figure: unmasked, masked, target mask, enlarged mask
    (reference extract_patches.py:282-311). Off by default (``save_fig``).

    Object-oriented matplotlib (no pyplot global state), imported here
    only, so it can run on the AsyncWriter thread."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    from ..io.images import im_adjust

    im_phase = np.array(output_mat[0], copy=True)
    im_phase_masked = np.array(masked_output_mat[0], copy=True)
    for im in (im_phase, im_phase_masked):
        nz = im[im != 0]
        if len(nz):
            im[im == 0] = np.nanmin(nz)
    ims = [im_adjust(im_phase), im_adjust(im_phase_masked), tm, tm2]
    names = ["output_mat", "masked_output_mat", "tm", "tm2"]
    fig = Figure(figsize=(15, 10))
    FigureCanvasAgg(fig)
    for i, (im, name) in enumerate(zip(ims, names)):
        a = fig.add_subplot(2, 2, i + 1)
        a.imshow(np.squeeze(im), cmap="gray")
        a.axis("off")
        a.set_title(name, fontsize=12)
    fig.savefig(im_path, dpi=300, bbox_inches="tight")


def get_cell_rect_angle(tm: np.ndarray) -> float:
    """Rotation angle (degrees) of a cell's long axis from the minimum-area
    rectangle of its largest contour (reference extract_patches.py:353-370),
    through ``native/contours`` in place of cv2."""
    contours = find_contours(np.asarray(tm).astype("uint8"))
    areas = [contour_area(c) for c in contours]
    (_, _), (w, h), ang = min_area_rect(contours[int(np.argmax(areas))])
    if w < h:
        ang = ang - 90
    return ang


def process_site_extract_patches_align_axis(
        site_path: str, site_segmentation_path: str,
        site_supp_files_folder: str, window_size: int = 256,
        channels: Optional[Sequence[int]] = None, save_fig: bool = False,
        skip_boundary: bool = False, device: Device = "cuda") -> None:
    """Long-axis-aligned patch extraction (reference extract_patches.py:
    373-492), per frame: each kept cell's enlarged window
    (``ceil(window * sqrt(2)) + 1``) from the device program of
    ``ops/patch.py``, the angle of its long axis on the host
    (``get_cell_rect_angle``), then one batched ``ops.geometry.warp_affine``
    on the device for every cell's four warps (the two masks as uint8, the
    raw and masked windows as uint16, cv2's arithmetics for those dtypes),
    and the central ``window`` crop. Saves ``stacks_rotated_<t>.pkl`` as
    the JAX package does."""
    dev = resolve_device(device)
    output_window_size = window_size
    window_size = int(np.ceil(window_size * np.sqrt(2)) + 1)
    image_stack = np.load(site_path)
    if channels is not None:
        image_stack = image_stack[:, np.asarray(channels)]
    segmentation_stack = np.load(site_segmentation_path)
    cell_positions = load_pickle(
        os.path.join(site_supp_files_folder, "cell_positions.pkl"))
    cell_pixel_assignments = load_pickle(
        os.path.join(site_supp_files_folder, "cell_pixel_assignments.pkl"))

    n_frames, _, _, x_size, y_size = image_stack.shape
    lo = window_size // 2 - output_window_size // 2
    hi = window_size // 2 + output_window_size // 2
    centre = (window_size / 2, window_size / 2)
    for t_point in range(n_frames):
        site_data: Dict[str, dict] = {}
        cell_segmentation = check_segmentation_dim(
            segmentation_stack[t_point])
        positions, positions_labels = cell_pixel_assignments[t_point]
        kept_cells = filter_boundary_cells(
            cell_positions[t_point], window_size // 2, x_size, y_size,
            skip_boundary)
        if kept_cells:
            raw = torch.from_numpy(
                image_stack[t_point, :, 0].astype(np.float32)).to(dev)
            bg_fill = median_background(raw, torch.from_numpy(
                cell_segmentation[0, 0].astype(np.float32)).to(dev))
            labels = labels_to_map((x_size, y_size), positions,
                                   positions_labels)
            out = dispatch_cell_patches(raw, labels, bg_fill, kept_cells,
                                        window_size=window_size, device=dev)
            tm_host = out["tm"].cpu().numpy()
            rot = np.stack([rotation_matrix_2d(
                centre, get_cell_rect_angle(tm), 1) for tm in tm_host])
            masks = torch.cat([out["tm"], out["tm2"]])[..., None]
            # float32 -> uint16 truncates, as numpy's astype does
            wins = torch.cat([out["mat"], out["masked_mat"]]) \
                .permute(0, 2, 3, 1).to(torch.uint16)
            masks, wins = warp_affine([masks, wins], np.concatenate([rot,
                                                                     rot]),
                                      (window_size, window_size))
            n = len(kept_cells)
            crop = (slice(None), slice(lo, hi), slice(lo, hi))
            masks = masks[crop][..., 0].cpu().numpy()
            wins = wins[crop].permute(0, 3, 1, 2).cpu().numpy()
            for i, (cid, _) in enumerate(kept_cells):
                cell_name = os.path.join(site_supp_files_folder,
                                         "%d_%d.h5" % (t_point, cid))
                tm_c = masks[i][None, None]
                tm2_c = masks[n + i][None, None]
                mat_c, masked_c = wins[i][:, None], wins[n + i][:, None]
                site_data[cell_name] = {
                    "mat": np.concatenate([mat_c, tm_c, tm2_c],
                                          0).astype("float64"),
                    "masked_mat": np.concatenate([masked_c, tm_c, tm2_c],
                                                 0).astype("float64"),
                }
                if save_fig:
                    save_single_cell_im(
                        mat_c[:, 0], masked_c[:, 0], tm_c[0, 0],
                        tm2_c[0, 0], os.path.join(
                            site_supp_files_folder,
                            "patch_rotated_t%d_id%d.jpg" % (t_point, cid)))
        save_pickle(site_data,
                    os.path.join(site_supp_files_folder,
                                 "stacks_rotated_%d.pkl" % t_point))


def process_site_build_trajectory(site_supp_files_folder: str,
                                  min_length: int = 10) -> None:
    """Track cells through time for one site; saves cell_traj.pkl,
    ``[trajectories, trajectory_positions]`` (reference
    generate_trajectories.py:372-438)."""
    cell_positions = load_pickle(
        os.path.join(site_supp_files_folder, "cell_positions.pkl"))
    cell_pixel_assignments = load_pickle(
        os.path.join(site_supp_files_folder, "cell_pixel_assignments.pkl"))
    trajectories, trajectories_positions = build_site_trajectories(
        cell_positions, cell_pixel_assignments, min_length=min_length)
    save_pickle([trajectories, trajectories_positions],
                os.path.join(site_supp_files_folder, "cell_traj.pkl"))


def extract_patches(raw_folder: str, supp_folder: str, sites: Sequence[str],
                    config, device: Device = "cuda") -> None:
    """Patch extraction over sites (reference pipeline/patch_VAE.py:22-74)."""
    dev = resolve_device(device)
    for site in sites:
        site_path = os.path.join(raw_folder, f"{site}.npy")
        seg_path = os.path.join(raw_folder, f"{site}_NNProbabilities.npy")
        supp = site_supp_folder(supp_folder, site)
        if not os.path.exists(site_path) or not os.path.exists(seg_path):
            log.error("Site data not found %s", site_path)
            continue
        os.makedirs(supp, exist_ok=True)
        with stage_timer("extract_patches", site=site):
            process_site_extract_patches(
                site_path, seg_path, supp,
                window_size=config.patch.window_size,
                channels=config.patch.channels,
                save_fig=config.patch.save_fig,
                reload=config.patch.reload,
                skip_boundary=config.patch.skip_boundary,
                storage=config.patch.storage, device=dev)


def build_trajectories(raw_folder: str, supp_folder: str,
                       sites: Sequence[str], config) -> None:
    """Trajectory building over sites (reference
    pipeline/patch_VAE.py:77-112)."""
    for site in sites:
        site_path = os.path.join(raw_folder, f"{site}.npy")
        supp = site_supp_folder(supp_folder, site)
        if not os.path.exists(site_path) or not os.path.exists(supp):
            log.error("Site data not found %s", site_path)
            continue
        with stage_timer("build_trajectories", site=site):
            process_site_build_trajectory(supp)


def instance_segmentation(raw_folder: str, supp_folder: str,
                          sites: Sequence[str], config, rerun: bool = True
                          ) -> None:
    """Instance segmentation over sites (reference
    pipeline/segmentation.py:90-141)."""
    for site in sites:
        site_path = os.path.join(raw_folder, f"{site}.npy")
        seg_path = os.path.join(raw_folder, f"{site}_NNProbabilities.npy")
        supp = site_supp_folder(supp_folder, site)
        if not os.path.exists(site_path) or not os.path.exists(seg_path):
            log.error("Site data not found %s", site_path)
            continue
        if not rerun and os.path.exists(
                os.path.join(supp, "cell_positions.pkl")):
            log.info("Found previously saved instance clustering for %s, "
                     "skip", site)
            continue
        os.makedirs(supp, exist_ok=True)
        with stage_timer("instance_segmentation", site=site):
            process_site_instance_segmentation(site_path, seg_path, supp)
