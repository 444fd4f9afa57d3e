"""The streaming front end: raw stacks -> latents in one pass, the port of
``dynamorph_tpu/pipeline/stream.py``.

The staged path goes through the disk twice between patch extraction and
the encode: ``extract_patches`` writes ``stacks_<t>.pkl``, ``assemble``
reads them, resizes 256 -> 128 on the host and writes ``static_patches``,
and ``process`` reads that and uploads it again. The fused stage
(pipeline/fused.py) has the patches on the card the moment they are
extracted; this module encodes them there:

    raw frame -> U-Net -> DBSCAN -> patch windows     (pipeline/fused.py)
      -> channel select + integer-factor resize       (card, this file)
      -> per-patch z-score + VQ-VAE encode             (card, the staged
                                                        ``encode_batch``)
      -> latents

``stacks_<t>``, ``static_patches``, ``file_paths`` and both latent pickles
are still written, so the later stages and resume do not change.

Exactness: cv2's INTER_LINEAR at an integer downscale f is the mean of the
central 2 x 2 of each f x f block (even f) or the block's centre pixel
(odd f) (``resize_select``). Patch values are integers or half-integers
below 2**16, so that mean is exact in float32 and equals the staged
float64 resize (``_resize_chw``). The encode is the staged path's own
``encode_batch`` at the same 512-row padded batch, so on the CPU the
streamed latents equal the staged ones bit for bit. The rows are put back
into sorted-name order at the end.

Frames fanned out over several devices (``seg_patch_fused``'s frame and
site groups) gather and encode on their own device, with the model's
replica there (``core.mesh.replica``): each device keeps its own rows
pending, and the sorted-name order at the end makes the result
independent of the device count and of the order in which frames arrive
(dynamorph_tpu/pipeline/stream.py:44-47).
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.device import HostCopy, device_scope, resolve_device
from ..core.mesh import replica
from ..core.profiling import stage_timer
from ..io.compact import save_array, storage_path
from ..io.pickles import load_pickle, save_pickle
from ..io.prefetch import AsyncWriter
from ..io.sites import group_sites_by_well, site_supp_folder
from ..models.registry import is_vae_family
from ..track.relations import generate_trajectory_relations
from .fused import build_seg_model, seg_patch_fused
from .patch_vae import (_build_model_from_config, _load_model_weights,
                        _save_recon_images, encode_batch,
                        resolve_latent_weights)

log = logging.getLogger(__name__)

Device = Union[str, torch.device]


def resize_select(mat: torch.Tensor, channels: Sequence[int],
                  factor: int) -> torch.Tensor:
    """Channel select and cv2-exact integer-factor downscale, on the
    tensor's device: (N, C, H, W) -> (N, len(channels), H / f, W / f)
    (``_resize_select_fn``, dynamorph_tpu/pipeline/stream.py:79-110).

    cv2 samples destination pixel d at ``f * d + f / 2 - 0.5``: for even
    f, halfway between the two central rows (and columns) of the block,
    weights (0.5, 0.5); for odd f, on the centre row itself."""
    start = (factor - 1) // 2
    taps = 2 if factor % 2 == 0 else 1
    x = mat[:, list(channels)]
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // factor, factor, w // factor, factor)
    x = x[:, :, :, start:start + taps, :, start:start + taps]
    return torch.mean(x, dim=(3, 5))


class StreamingWellEncoder:
    """Takes one well's patch tensors from the fused stage's
    ``frame_hook``, resizes them and encodes them on their device as soon
    as a full batch has gathered there, and returns the well's artifacts in
    sorted-name order (see the module docstring).

    Site workers of ``seg_patch_fused`` call ``add_frame`` at once: a lock
    holds the pending rows and the dispatches (each is only queued on the
    card).

    Args:
        model: the latent model (VQ-VAE family); a replica of it encodes
            on each device that frames come from.
        channels: the PATCH channels fed to the model (reference assemble
            channel select, patch_VAE.py:150-156); raw channels only.
        window_size / input_size: patch and model sizes; window_size must
            be an integer multiple of input_size.
        batch_size: rows of one encode dispatch (the trailing one is
            zero-padded).
        patch_key: "mat" or "masked_mat".
    """

    def __init__(self, model, channels: Sequence[int],
                 window_size: int = 256, input_size: int = 128,
                 batch_size: int = 512, patch_key: str = "mat"):
        if window_size % input_size:
            raise ValueError(
                f"streaming resize needs window_size ({window_size}) to be "
                f"an integer multiple of the model input ({input_size}); "
                "use the staged assemble for other geometries")
        self.model = model
        self.channels = tuple(int(c) for c in channels)
        self.factor = window_size // input_size
        self.batch_size = int(batch_size)
        self.patch_key = patch_key
        self._lock = threading.Lock()
        # a device's rows resized but not encoded yet: [(names, (n, C, h,
        # w) tensor)]
        self._pending: Dict[torch.device, List] = {}
        # encode results in dispatch order: (names, z_before, z_after)
        self._encoded: List = []
        # the resized rows' host copies, for static_patches
        self._resized: List = []
        # encode dispatches a device
        self.dispatches: Dict[torch.device, int] = {}

    def add_frame(self, site_supp_folder: str, t_point: int, patch_out,
                  kept_cells, dev) -> None:
        """One frame's patch tensors on ``dev``: select and resize there,
        copy to the host for static_patches, encode every full batch of
        ``dev``'s rows. The names are ``assemble_site_data``'s keys."""
        if not kept_cells:
            return
        mat = patch_out[self.patch_key]
        if max(self.channels) >= mat.shape[1]:
            raise ValueError(
                f"streaming channels {self.channels} address beyond the "
                f"{mat.shape[1]} extracted patch channels (tm/tm2 masks "
                "are appended only in the pickle artifacts)")
        names = [os.path.join(site_supp_folder, "%d_%d.h5" % (t_point, cid))
                 for cid, _ in kept_cells]
        dev = torch.device(dev)
        with self._lock, device_scope(dev):
            resized = resize_select(mat, self.channels, self.factor)
            self._resized.append((names, HostCopy(resized)))
            self._pending.setdefault(dev, []).append((names, resized))
            while self._pending_rows(dev) >= self.batch_size:
                self._dispatch(dev, self.batch_size)

    def _pending_rows(self, dev: torch.device) -> int:
        return sum(len(nm) for nm, _ in self._pending[dev])

    def _dispatch(self, dev: torch.device, rows: int) -> None:
        """Encode the first ``rows`` of ``dev``'s pending rows in one
        dispatch on ``dev``; the results stay there until ``finish``."""
        pend = self._pending[dev]
        names = [n for nm, _ in pend for n in nm]
        x = torch.cat([r for _, r in pend], 0)
        z_b, z_a = encode_batch(replica(self.model, dev), x[:rows],
                                self.batch_size, normalize="patch")
        self._encoded.append((names[:rows], z_b, z_a))
        self._pending[dev] = [(names[rows:], x[rows:])] if len(x) > rows \
            else []
        self.dispatches[dev] = self.dispatches.get(dev, 0) + 1

    def finish(self):
        """Encode what is left and return the well's artifacts in sorted
        patch-name order: (file_paths, z_before (N, D*), z_after (N, D*),
        static_patches float64 (N, C, 1, h, w) with the reference's stale z
        axis)."""
        with self._lock:
            for dev in list(self._pending):
                n = self._pending_rows(dev)
                if n:
                    with device_scope(dev):
                        self._dispatch(dev, n)
        names = [n for nm, _, _ in self._encoded for n in nm]
        if not names:
            raise ValueError(
                "no patches streamed for this well — upstream segmentation/"
                "instance clustering produced no cells")
        order = np.argsort(np.asarray(names))
        z_b = torch.cat([z.cpu() for _, z, _ in self._encoded]).numpy()
        z_a = torch.cat([z.cpu() for _, _, z in self._encoded]).numpy()
        rnames = [n for nm, _ in self._resized for n in nm]
        flat = np.concatenate([c.wait() for _, c in self._resized], 0)
        dataset = flat.astype(np.float64)[:, :, None][
            np.argsort(np.asarray(rnames))]
        return [names[i] for i in order], z_b[order], z_a[order], dataset


def seg_patch_stream(raw_folder: str, supp_folder: str,
                     sites: Sequence[str], config, rerun: bool = True,
                     batch_size: int = 512,
                     patch_type: Optional[str] = None,
                     device: Device = "cuda",
                     site_parallelism: Optional[int] = None,
                     devices: Optional[Sequence] = None) -> None:
    """The fused stage with the streaming encoder attached: one pass over
    the raw stacks writes the fused stage's artifacts and, per well,
    ``<well>_file_paths.pkl``, ``<well>_static_patches.pkl`` and both
    latent pickles (reference pipeline/patch_VAE.py:115-175 and :343-508);
    with ``save_output`` the recon images too. Relations and labels need
    trajectories: ``assemble_relations`` after ``build_trajectories``.

    ``batch_size``: rows of one encode dispatch, as ``process_vae``'s.
    ``patch_type``: "mat" or "masked_mat" (default
    ``latent_encoding.patch_type``). The encoder takes the patches from
    the live frame hook, so a skipped site would stream nothing: ``rerun``
    is forced to True. A well in which a site failed raises, and none of
    its latents are written.

    ``site_parallelism`` and ``devices``: ``seg_patch_fused``'s site groups
    and frame fan-out (dynamorph_tpu/pipeline/stream.py:313-410); each
    frame's patches are encoded on the device the frame ran on.
    """
    le = config.latent_encoding
    if not is_vae_family(le.network):
        # the ResNet branch of process_vae normalises on the host and has
        # no streaming form (the orchestrator routes it to the staged path)
        raise ValueError(
            f"streaming latent encode supports the VAE family only, got "
            f"network '{le.network}' — run the fused front-end + staged "
            "assemble/process for ResNet encoders")
    patch_type = patch_type or le.patch_type
    if not rerun:
        log.warning("seg_patch_stream streams patches from the live frame "
                    "hook — rerun=False would skip completed sites and "
                    "stream nothing for them; forcing rerun=True")
    dev = resolve_device(device)
    model = _build_model_from_config(le, num_inputs=2)
    _, model_path, model_name = resolve_latent_weights(le)
    _load_model_weights(model, model_path)
    model.to(dev)
    output_dir = os.path.join(raw_folder, model_name)
    os.makedirs(output_dir, exist_ok=True)
    storage = le.storage
    seg_model = build_seg_model(config, device=dev)

    wells = group_sites_by_well(sites)
    with AsyncWriter(depth=2) as writer:
        for well in sorted(wells):
            enc = StreamingWellEncoder(
                model, le.channels, window_size=config.patch.window_size,
                input_size=le.input_size or 128,
                batch_size=batch_size, patch_key=patch_type)

            def hook_for(site):
                supp = site_supp_folder(supp_folder, site)
                return lambda t, out, kept, d: enc.add_frame(supp, t, out,
                                                             kept, d)

            with stage_timer("seg_patch_stream", well=well):
                failures = seg_patch_fused(
                    raw_folder, supp_folder, wells[well], config, rerun=True,
                    model=seg_model, frame_hook_for=hook_for, device=dev,
                    site_parallelism=site_parallelism, devices=devices)
                if failures:
                    # latents of a partial well would look complete to the
                    # orchestrator's skip rule and never be redone
                    raise RuntimeError(
                        f"well {well}: fused front-end failed for sites "
                        f"{[s for s, _ in failures]} — not writing "
                        "partial latents/static_patches"
                    ) from failures[0][1]
                fs, z_b, z_a, dataset = enc.finish()

            save_pickle(fs, os.path.join(raw_folder,
                                         f"{well}_file_paths.pkl"))
            for array, path in (
                    (dataset, os.path.join(raw_folder,
                                           f"{well}_static_patches.pkl")),
                    (z_b, os.path.join(output_dir,
                                       f"{well}_latent_space.pkl")),
                    (z_a, os.path.join(output_dir,
                                       f"{well}_latent_space_after.pkl"))):
                writer.submit(save_array, array,
                              storage_path(path, storage), storage=storage)
            if le.save_output:
                writer.submit(_save_recon_images, model, dataset[:, :, 0],
                              output_dir, device=dev)


def assemble_relations(raw_folder: str, supp_folder: str,
                       sites: Sequence[str], config) -> None:
    """The trajectory-relation half of ``assemble`` for a streamed well:
    ``file_paths`` and ``static_patches`` are already written, and the
    relations and labels need ``build_trajectories``' cell_traj.pkl
    (reference patch_VAE.py:157-175)."""
    for well, well_sites in group_sites_by_well(sites).items():
        fs = load_pickle(os.path.join(raw_folder, f"{well}_file_paths.pkl"))
        relations, labels = generate_trajectory_relations(
            fs, well_sites, os.path.join(supp_folder, f"{well}-supps"))
        save_pickle(relations, os.path.join(
            raw_folder, f"{well}_static_patches_relations.pkl"))
        save_pickle(labels, os.path.join(
            raw_folder, f"{well}_static_patches_labels.pkl"))
