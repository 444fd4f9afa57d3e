"""The fused, device-resident segmentation -> instance -> patch stage, the
port of ``dynamorph_tpu/pipeline/fused.py``.

The staged path sends every frame through the host three times:
``segmentation`` downloads the probability map, ``instance_segmentation``
reads it back from disk, and ``extract_patches`` uploads the frame again.
Only DBSCAN needs the host, and it needs one bit a pixel. Per frame, this
stage:

1. uploads the frame once: the channels it uses, as float32 (a float64
   stack holds uint16 integers, so the host cast is exact), or as uint16
   when the stack is uint16;
2. on the card: casts, divides by ``CHANNEL_MAX``, runs the U-Net
   (``Segment.probabilities``), thresholds the mean background probability
   and packs the foreground into bits (``ops/patch.py::pack_mask_bits``);
   the packed mask starts its copy to the host at once (``HostCopy``);
3. clusters on a host thread: native DBSCAN and the size and window
   filters (``track/clustering.py``);
4. uploads the (pixel, label) list (int16 where it fits, 6 bytes a
   foreground pixel) and scatters it into the label map on the card,
   where the frame and the probabilities still are; the background median
   comes from them too;
5. runs the window, mask and fill program (``dispatch_cell_patches``) and
   copies only the patches back.

The loop is software-pipelined: the uploads and U-Nets of the next
``cluster_workers`` frames are queued ahead of the frame being consumed,
their DBSCAN runs on a thread pool (the native solver releases the GIL),
and frame t's patch fetch, pickle assembly and probability fetch drain on
an ``AsyncWriter`` thread. Neither pool thread launches CUDA work: each
waits on the event of a copy that the main thread started.

The artifacts are those of the three staged stages. Given the same
probabilities they are equal (``tests/test_torch_fused.py``); the U-Net
runs at batch 1 on the whole frame, as the staged direct mode does.

Over several devices (this process's cards by default) a site's frames go
round-robin, frame t on ``devices[t % len]``, each on the model's replica
there (``core.mesh.replica``), and ``seg_patch_fused`` runs
``site_parallelism`` sites at once, each worker thread checking a group of
the devices out of a queue of free groups (``core.mesh.device_groups``).
Frames are still consumed in order, so every artifact is the same for any
device list and any site parallelism.
"""
from __future__ import annotations

import logging
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from queue import Queue
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.constants import CHANNEL_MAX
from ..core.device import HostCopy, device_scope, resolve_device, upload
from ..core.mesh import (device_groups, fan_out_devices, model_device,
                         replica)
from ..core.profiling import stage_timer
from ..io.compact import save_stack, storage_path
from ..io.pickles import save_pickle
from ..io.png import write_png
from ..io.prefetch import AsyncWriter
from ..io.sites import site_supp_folder
from ..ops.patch import median_background, pack_mask_bits, scatter_label_map
from ..seg.data import plot_prediction_prob
from ..seg.model import Segment
from ..track.clustering import cluster_foreground_positions, save_instance_map
from .patch import assemble_site_data, dispatch_cell_patches, \
    filter_boundary_cells

log = logging.getLogger(__name__)

Device = Union[str, torch.device]


def _seg_frame(model, frame: torch.Tensor, seg_ch, fg_thr: float):
    """(C, H, W) frame on the device -> (float32 frame, probabilities
    (K, Z, H, W), packed foreground mask (H, W / 8)): foreground is a mean
    background probability under ``fg_thr`` (reference
    instance_clustering.py:63-65)."""
    frame = frame.to(torch.float32)
    probs = model.probabilities(frame[list(seg_ch)][None] / CHANNEL_MAX)[0]
    fg = torch.mean(probs[0], dim=0) < fg_thr
    return frame, probs, pack_mask_bits(fg)


def process_site_seg_patch_fused(
        site_path: str, model, site_supp_files_folder: str,
        seg_channels: Sequence[int], patch_channels: Sequence[int],
        window_size: int = 256, save_fig: bool = False,
        skip_boundary: bool = False, fg_thr: float = 0.3,
        ct_thr: Tuple[int, int] = (500, 12000),
        dbscan_thr: Tuple[int, int] = (10, 250),
        storage: str = "pickle", cluster_workers: Optional[int] = None,
        frame_hook=None, devices: Optional[Sequence] = None,
        lookahead: bool = True) -> dict:
    """Segment, cluster and extract patches for one site with the frame
    and the probabilities on the model's device throughout (see the module
    docstring).

    ``model``: a ``seg.model.Segment``, or anything with a ``device`` and
    ``probabilities((1, C, H, W) float32 in [0, 1]) -> (1, K, Z, H, W)``.

    ``devices``: the devices the frames go round (frame t on
    ``devices[t % len]``; dynamorph_tpu/pipeline/fused.py:142-252);
    default the model's device alone. The frames in flight are at least as
    many as the devices, so each has a frame queued.

    ``lookahead``: queue the next frames' uploads and U-Nets ahead of the
    host work on the current one. Off, the stage runs one frame at a time,
    clusters on this thread with all the cores, and uses the first device
    only (more would run nothing in parallel).

    ``frame_hook``: optional ``(t_point, patch_out, kept_cells, device)``,
    called on this thread right after frame t's patch program is queued,
    with the patch tensors still on the device (the streaming encode,
    pipeline/stream.py, attaches here).

    ``cluster_workers``: host threads clustering frames ahead (default
    min(3, cpu_count)); the uploads and U-Nets of that many frames are
    queued ahead of the host work on the current one, so the device holds
    ``cluster_workers + 1`` frames. Frames are consumed in order, so every
    artifact is the same for any value. The solver's own threads are the
    cores divided by the frames in flight.

    Each frame's probabilities land in pinned memory and are copied, on
    the writer thread, into one pageable (T, K, Z, H, W) array, so the
    pinned memory held is that of the frames in flight, not of the site.

    Returns {"frames", "h2d_bytes", "d2h_bytes"}: the bytes this stage
    copied each way (the probability fetch included).
    """
    devices = [model_device(model)] if devices is None else \
        fan_out_devices(devices, None)
    if not lookahead:
        devices = devices[:1]
    image_stack = np.load(site_path, mmap_mode="r")  # (T, C, Z, H, W)
    if image_stack.ndim != 5:
        raise ValueError(f"expected 5-D site stack, got {image_stack.shape}")
    os.makedirs(site_supp_files_folder, exist_ok=True)
    n_frames = image_stack.shape[0]
    x_size, y_size = image_stack.shape[-2:]
    half = window_size // 2
    # upload only the channels the stage reads, and index them there
    used = sorted({int(c) for c in seg_channels} |
                  {int(c) for c in patch_channels})
    seg_ch = [used.index(int(c)) for c in seg_channels]
    patch_ch = [used.index(int(c)) for c in patch_channels]
    moved = {"frames": n_frames, "h2d_bytes": 0, "d2h_bytes": 0}

    if cluster_workers is None:
        cluster_workers = max(1, min(3, os.cpu_count() or 1))
    # frames in flight beyond the one consumed; none without lookahead
    window = max(1, int(cluster_workers), len(devices)) if lookahead else 0
    # the cores split between frames (the pool) and the solver's threads
    dbscan_threads = max(1, (os.cpu_count() or 1) // max(1, window))

    def frame_device(t_point: int) -> torch.device:
        return devices[t_point % len(devices)]

    def host_cluster(packed: HostCopy):
        # on a pool thread: the packed mask's copy, the unpack to row-major
        # coordinates (np.argwhere's order, as in the staged path) and the
        # GIL-free native DBSCAN overlap the other frames
        fg = np.unpackbits(packed.wait(), axis=1,
                           bitorder="little").astype(bool)[:, :y_size]
        return cluster_foreground_positions(
            np.argwhere(fg), (x_size, y_size), ct_thr=ct_thr,
            instance_map=False, dbscan_thr=dbscan_thr,
            threads=dbscan_threads)

    cluster_pool = ThreadPoolExecutor(max_workers=window) if window else None
    inflight = deque()

    def enqueue(t_point: int) -> None:
        raw = image_stack[t_point, used, 0]
        if raw.dtype != np.uint16:
            raw = raw.astype(np.float32)
        dev = frame_device(t_point)
        with device_scope(dev):
            frame, probs, packed = _seg_frame(
                replica(model, dev), upload(raw, dev), seg_ch, fg_thr)
            # both copies start behind this frame's U-Net, before the next
            # frame's is queued on the same stream
            packed = HostCopy(packed)
            prob_copy = HostCopy(probs)
        moved["h2d_bytes"] += raw.nbytes
        moved["d2h_bytes"] += packed.nbytes + prob_copy.nbytes
        fut = cluster_pool.submit(host_cluster, packed) if cluster_pool \
            else None
        inflight.append((t_point, frame, probs, prob_copy, packed, fut))

    def extract(t_point, frame, probs, kept_cells, positions,
                positions_labels, dev) -> dict:
        """Queue the frame's label map and patch program on ``dev``, hand
        the patches to the frame hook and start their copies home."""
        # exactly the listed pixels go up: int16 when they fit
        small = max(x_size, y_size) <= 32767 and \
            int(positions_labels.max(initial=0)) <= 32767
        cdtype = np.int16 if small else np.int32
        coords = upload(positions.astype(cdtype), dev)
        labs = upload(positions_labels.astype(cdtype), dev)
        moved["h2d_bytes"] += coords.nbytes + labs.nbytes + \
            len(kept_cells) * 12         # centres and ids
        labels = scatter_label_map(coords, labs, (x_size, y_size))
        raw2d = frame[patch_ch]
        patch_out = dispatch_cell_patches(
            raw2d, labels, median_background(raw2d, probs[0, 0]),
            kept_cells, window_size=window_size, device=dev)
        if frame_hook is not None:
            frame_hook(t_point, patch_out, kept_cells, dev)
        copies = {k: HostCopy(v) for k, v in patch_out.items()}
        moved["d2h_bytes"] += sum(c.nbytes for c in copies.values())
        return copies

    cell_positions = {}
    cell_pixel_assignments = {}
    prob_total = None    # (T, K, Z, H, W), filled on the writer thread
    writer = AsyncWriter(depth=2)
    try:
        next_t = 0
        while next_t < n_frames or inflight:
            while next_t < n_frames and len(inflight) < window + 1:
                enqueue(next_t)
                next_t += 1
            t_point, frame, probs, prob_copy, packed, fut = \
                inflight.popleft()
            all_cells, positions, positions_labels = \
                fut.result() if fut is not None else host_cluster(packed)
            cell_pixel_assignments[t_point] = (positions, positions_labels)
            # the staged path writes no instance map for a frame that
            # clustering skips (MIN_FG_PIXELS), so neither does this one
            if len(positions):
                writer.submit(save_instance_map, all_cells, positions,
                              positions_labels, (x_size, y_size),
                              os.path.join(site_supp_files_folder,
                                           "segmentation_%d.png" % t_point))
            kept_cells = filter_boundary_cells(all_cells, half, x_size,
                                               y_size, skip_boundary)
            cell_positions[t_point] = kept_cells

            patch_copies = None
            if kept_cells:
                dev = frame_device(t_point)
                with device_scope(dev):
                    patch_copies = extract(t_point, frame, probs, kept_cells,
                                           positions, positions_labels, dev)

            # the patch fetch, assembly and write, and the probability
            # fetch, drain on the writer thread
            def fetch_and_save(copies=patch_copies, kept=kept_cells,
                               t=t_point, p=prob_copy):
                nonlocal prob_total
                out = None if copies is None else \
                    {k: c.wait() for k, c in copies.items()}
                save_stack(
                    assemble_site_data(out, kept, site_supp_files_folder, t,
                                       save_fig=save_fig),
                    storage_path(os.path.join(site_supp_files_folder,
                                              "stacks_%d.pkl" % t), storage),
                    storage=storage)
                landed = p.wait()
                if prob_total is None:
                    prob_total = np.empty((n_frames,) + landed.shape,
                                          landed.dtype)
                prob_total[t] = landed

            writer.submit(fetch_and_save)
            # the frame's device tensors go before the next frame is
            # queued; its pinned probabilities once the writer copied them
            del frame, probs, prob_copy
    finally:
        writer.close()
        if cluster_pool is not None:
            cluster_pool.shutdown(wait=True)

    stem = os.path.splitext(site_path)[0]
    np.save(stem + "_NNProbabilities", prob_total)
    # the previews of the staged stage (seg/inference.py::_finish_whole_map)
    write_png(stem + ".png", image_stack[0, int(seg_channels[0]), 0])
    plot_prediction_prob(prob_total[0], stem + "_NNpred.png")

    # cell_positions.pkl is the completion marker of resume and of the
    # per-site skip, so it is written last: a site that fails above is
    # left unmarked and runs again
    save_pickle(cell_pixel_assignments,
                os.path.join(site_supp_files_folder,
                             "cell_pixel_assignments.pkl"))
    save_pickle(cell_positions,
                os.path.join(site_supp_files_folder, "cell_positions.pkl"))
    log.info("[fused] %s: %d frames, host->device %d bytes, device->host %d "
             "bytes", site_path, n_frames, moved["h2d_bytes"],
             moved["d2h_bytes"])
    return moved


def build_seg_model(config, device: Device = "cuda") -> Segment:
    """The fused stage's U-Net from ``config.segmentation_inference``
    (``build_seg_model``, dynamorph_tpu/pipeline/fused.py:383-401), so a
    caller over several wells builds it once."""
    si = config.segmentation_inference
    if si.network != "UNet":
        raise NotImplementedError(
            f"segmentation model {si.network} not implemented")
    model = Segment(input_shape=(len(si.channels), si.window_size,
                                 si.window_size),
                    n_classes=si.num_classes, device=device)
    if not si.weights:
        raise ValueError("segmentation weights path must be provided")
    model.load(si.weights)
    return model


def seg_patch_fused(raw_folder: str, supp_folder: str, sites: Sequence[str],
                    config, rerun: bool = True, model=None,
                    frame_hook_for=None, device: Device = "cuda",
                    site_parallelism: Optional[int] = None,
                    devices: Optional[Sequence] = None) -> list:
    """The fused stage over sites, with one model for all of them and the
    staged path's per-site failure tolerance (reference
    pipeline/segmentation.py:76-86). Returns the ``(site, exception)``
    pairs of the sites that failed, empty on a clean run.

    ``rerun=False`` skips a site whose ``cell_positions.pkl`` (written
    last) exists. ``model``: a ``build_seg_model`` result to reuse.
    ``frame_hook_for``: optional ``site -> frame_hook`` (see
    ``process_site_seg_patch_fused``).

    ``devices`` (default: this process's cards when ``device`` is the
    card) are dealt round-robin into ``site_parallelism`` groups (default
    ``min(len(devices), len(sites))``, clamped to both): that many worker
    threads run sites at once, each taking whichever group is free from a
    queue and fanning its site's frames over that group
    (dynamorph_tpu/pipeline/fused.py:404-522). With one group the sites run
    one after another on every device. Each worker queues its CUDA work
    under ``torch.cuda.device`` of its group's first device.
    """
    dev = resolve_device(device)
    if model is None:
        model = build_seg_model(config, device=dev)
    devices = fan_out_devices(devices, dev)
    k = site_parallelism if site_parallelism is not None \
        else min(len(devices), len(sites))
    k = max(1, min(k, len(devices), max(len(sites), 1)))
    si = config.segmentation_inference
    failed: list = []

    def run_site(site: str, group: list) -> None:
        site_path = os.path.join(raw_folder, f"{site}.npy")
        if not os.path.exists(site_path):
            log.error("Site data not found %s", site_path)
            failed.append((site, FileNotFoundError(site_path)))
            return
        supp = site_supp_folder(supp_folder, site)
        if not rerun and os.path.exists(
                os.path.join(supp, "cell_positions.pkl")):
            log.info("Found previously saved fused outputs for %s, skip",
                     site)
            return
        hook = frame_hook_for(site) if frame_hook_for is not None else None
        try:
            with stage_timer("seg_patch_fused", site=site), \
                    device_scope(group[0]):
                process_site_seg_patch_fused(
                    site_path, model, supp, seg_channels=si.channels,
                    patch_channels=config.patch.channels,
                    window_size=config.patch.window_size,
                    save_fig=config.patch.save_fig,
                    skip_boundary=config.patch.skip_boundary,
                    storage=config.patch.storage,
                    cluster_workers=config.patch.cluster_workers,
                    frame_hook=hook, devices=group)
        except Exception as ex:  # per-site failure tolerance
            log.exception("Error in fused seg->patch for site %s", site)
            failed.append((site, ex))

    if k == 1:
        for site in sites:
            run_site(site, devices)
        return failed
    # free-group checkout: a worker takes whichever group is idle, so two
    # long sites do not pile up on one group while another waits
    free: Queue = Queue()
    for group in device_groups(devices, k):
        free.put(group)

    def run_on_free_group(site: str) -> None:
        group = free.get()
        try:
            run_site(site, group)
        finally:
            free.put(group)

    with ThreadPoolExecutor(max_workers=k) as pool:
        for fut in [pool.submit(run_on_free_group, s) for s in sites]:
            fut.result()
    return failed
