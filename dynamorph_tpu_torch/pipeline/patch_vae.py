"""VAE dataset assembly, latent encoding and trajectory matching, the port
of ``dynamorph_tpu/pipeline/patch_vae.py`` (reference pipeline/patch_VAE.py:
assemble_VAE :115-175, process_VAE :343-508, combine_dataset :178-254,
trajectory_matching :257-318; HiddenStateExtractor/vq_vae_supp.py:114-146).

Assembly, combination and trajectory matching are host steps over pickles,
as in the JAX package; the 256 -> 128 resize is cv2's bilinear rule
(``_resize_chw``) computed with numpy.

Patches are encoded in batches on the card: per-patch z-score on the
device, the VQ-VAE encoder, the codebook lookup kernel
(``ops/csrc/vq_lookup.cu``). The output pickles are those of the reference
and of the JAX package: ``<raw>/<model_name>/<well>_latent_space.pkl``
(pre-VQ) and ``<well>_latent_space_after.pkl`` (post-VQ), float32
``(N, D*H*W)`` in NCHW order.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.mesh import local_devices, pad_to_multiple, replica, shard_batch
from ..core.profiling import stage_timer
from ..io.compact import (load_array_any, load_stack_any, save_array,
                          storage_path)
from ..io.pickles import load_pickle, save_pickle
from ..io.sites import site_supp_folder, well_of
from ..models.jax_import import load_reference_checkpoint
from ..models.registry import build_model, is_vae_family
from ..models.resnet_simclr import EncodeProject
from ..models.vae import VAEModel
from ..track.relations import generate_trajectory_relations, patch_name_to_tuple
from ..train.data import zscore_patch

log = logging.getLogger(__name__)

Device = Union[str, torch.device]


def _linear_taps(n_src: int, n_dst: int, clamp: bool):
    """cv2's INTER_LINEAR taps along one axis: the sample position
    ``(dst + 0.5) * scale - 0.5`` in float32, its floor i and weights
    ``(1 - w, w)`` as float32 values, from source rows (i, i + 1) clipped
    to the axis. ``clamp`` (cv2 does it along x only) also sets w = 0 where
    i falls off either end."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    w = f - i.astype(np.float32)
    if clamp:
        off = (i < 0) | (i >= n_src - 1)
        i[off] = np.where(i[off] < 0, 0, n_src - 1)
        w[off] = 0
    w0 = (np.float32(1) - w).astype(np.float64)
    return (np.clip(i, 0, n_src - 1), np.clip(i + 1, 0, n_src - 1), w0,
            w.astype(np.float64))


def _resize_chw(dat: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """cv2's bilinear resize (``cv2.resize(x, hw)``, INTER_LINEAR; hw is
    (width, height) as cv2 takes it) over the trailing (H, W) of a
    (..., H, W) float array, computed with numpy in float64 (reference
    cv2_fn_wrapper, extract_patches.py:21-37).

    The arithmetic is OpenCV's generic CPU path, which cv2 takes for the
    pipeline's 2-channel patches: an exact 2x downscale in both axes is
    its fast area mean, ``(((a + b) + c) + d) * 0.25`` over each 2 x 2
    block; any other size is a horizontal pass, then a vertical one, each
    ``S0 * (1 - w) + S1 * w`` with float32 positions and weights. On
    2-channel arrays it equals cv2 bit for bit at every size. cv2 5.0
    computes 1-, 3- and 4-channel arrays another way; there the two agree
    exactly at integer factors on pipeline values (multiples of 0.5 below
    2**16, where every form is exact), and within 2.5e-6 of the largest
    magnitude otherwise.
    """
    dat = np.asarray(dat, dtype=np.float64)
    dst_w, dst_h = hw
    src_h, src_w = dat.shape[-2:]
    if 2 * dst_w == src_w and 2 * dst_h == src_h:
        a, b = dat[..., 0::2, 0::2], dat[..., 0::2, 1::2]
        c, d = dat[..., 1::2, 0::2], dat[..., 1::2, 1::2]
        return (((a + b) + c) + d) * 0.25
    x0, x1, wx0, wx1 = _linear_taps(src_w, dst_w, clamp=True)
    y0, y1, wy0, wy1 = _linear_taps(src_h, dst_h, clamp=False)
    h = dat[..., x0] * wx0 + dat[..., x1] * wx1
    return h[..., y0, :] * wy0[:, None] + h[..., y1, :] * wy1[:, None]


def prepare_dataset(dat_fs: Sequence[str], channels=None,
                    input_shape: Tuple[int, int] = (128, 128),
                    key: str = "masked_mat"):
    """Read stacks_*.pkl dicts, select channels, resize to ``input_shape``,
    stack sorted by patch name (reference vq_vae_supp.py:114-146)."""
    tensors = {}
    for dat_f in dat_fs:
        log.info("loading data %s", dat_f)
        file_dats = load_stack_any(dat_f)
        for k, v in file_dats.items():
            dat = np.asarray(v[key])
            cs = np.arange(dat.shape[0]) if channels is None \
                else np.asarray(channels)
            dat = dat[cs].astype(float)
            tensors[k] = _resize_chw(dat, input_shape)
    ts_keys = sorted(tensors.keys())
    if not ts_keys:
        raise ValueError(
            "no patches found in any stacks_*.pkl — upstream segmentation/"
            "instance clustering produced no cells")
    dataset = np.stack([tensors[k] for k in ts_keys], 0)
    return dataset, ts_keys


def assemble_vae(raw_folder: str, supp_folder: str, sites: Sequence[str],
                 config, patch_type: Optional[str] = None) -> None:
    """Assemble a well's VAE input dataset, relations and labels
    (reference pipeline/patch_VAE.py:115-175): ``<well>_file_paths.pkl``,
    ``<well>_static_patches.pkl`` (or .npz with ``storage: compact``),
    ``<well>_static_patches_relations.pkl`` and
    ``<well>_static_patches_labels.pkl`` in ``raw_folder``."""
    le = config.latent_encoding
    channels = le.channels
    patch_type = patch_type or le.patch_type
    if len(channels) == 0:
        raise ValueError("At least one channel must be specified")
    if len({well_of(s) for s in sites}) != 1:
        raise ValueError("Sites should be from a single well/condition")
    well = well_of(sites[0])

    storage = le.storage
    dat_fs = []
    for site in sites:
        folder = site_supp_folder(supp_folder, site)
        # stacks may exist as .pkl (reference contract) and/or .npz
        # (compact storage): dedupe by stem, preferring the configured
        # storage's extension when both are present
        stems: dict = {}
        prefer_ext = ".npz" if storage == "compact" else ".pkl"
        for f in sorted(os.listdir(folder)):
            stem, ext = os.path.splitext(f)
            if not f.startswith("stacks") or ext not in (".pkl", ".npz"):
                continue
            if stem not in stems or ext == prefer_ext:
                stems[stem] = f
        dat_fs.extend(os.path.join(folder, stems[s]) for s in sorted(stems))

    input_size = int(le.input_size or 128)
    dataset, fs = prepare_dataset(dat_fs, channels=channels, key=patch_type,
                                  input_shape=(input_size, input_size))

    save_pickle(fs, os.path.join(raw_folder, f"{well}_file_paths.pkl"))
    save_array(dataset,
               storage_path(
                   os.path.join(raw_folder, f"{well}_static_patches.pkl"),
                   storage),
               storage=storage)

    well_supp = os.path.join(supp_folder, f"{well}-supps")
    relations, labels = generate_trajectory_relations(fs, sites, well_supp)
    save_pickle(relations,
                os.path.join(raw_folder,
                             f"{well}_static_patches_relations.pkl"))
    save_pickle(labels,
                os.path.join(raw_folder, f"{well}_static_patches_labels.pkl"))


def combine_dataset(input_dataset_names: Sequence[str],
                    output_dataset_name: str, save_mask: bool = True) -> None:
    """Merge several per-well datasets into one, sorted by patch name
    (reference pipeline/patch_VAE.py:178-254)."""
    separate_fs, separate_dataset = [], []
    separate_mask, separate_relations = [], []
    for n in input_dataset_names:
        separate_fs.append(load_pickle(n + "_file_paths.pkl"))
        separate_dataset.append(load_array_any(n + "_static_patches.pkl"))
        separate_relations.append(
            load_pickle(n + "_static_patches_relations.pkl"))
        if save_mask:
            separate_mask.append(
                load_array_any(n + "_static_patches_mask.pkl"))

    all_fs = sorted(sum(separate_fs, []))
    if len(all_fs) != len(set(all_fs)):
        raise ValueError("Found patches with identical name")
    save_pickle(all_fs, output_dataset_name + "_file_paths.pkl")

    name_to_src = {n: (i, j) for i, fs in enumerate(separate_fs)
                   for j, n in enumerate(fs)}
    name_to_idx = {n: i for i, n in enumerate(all_fs)}
    order = [name_to_src[n] for n in all_fs]

    all_dataset = np.stack([separate_dataset[i][j] for i, j in order], 0)
    save_pickle(all_dataset, output_dataset_name + "_static_patches.pkl")
    if save_mask:
        all_mask = np.stack([separate_mask[i][j] for i, j in order], 0)
        save_pickle(all_mask, output_dataset_name + "_static_patches_mask.pkl")

    all_relations = {}
    for fs, relation in zip(separate_fs, separate_relations):
        for (a, b), v in relation.items():
            all_relations[(name_to_idx[fs[a]], name_to_idx[fs[b]])] = v
    save_pickle(all_relations,
                output_dataset_name + "_static_patches_relations.pkl")


def trajectory_matching(summary_folder: str, supp_folder: str,
                        sites: Sequence[str]) -> None:
    """Map each site's cell trajectories to lists of patch indices into the
    well's ``file_paths`` and save ``<well>_trajectories.pkl`` (reference
    pipeline/patch_VAE.py:257-318). A trajectory is kept when more than
    95% of its frames have a patch."""
    if len({well_of(s) for s in sites}) != 1:
        raise ValueError("Sites should be from a single well/condition")
    well = well_of(sites[0])
    fs = load_pickle(os.path.join(summary_folder, f"{well}_file_paths.pkl"))
    patch_id_mapping = {patch_name_to_tuple(f, sites): i
                        for i, f in enumerate(fs)}

    site_trajs = {}
    for site in sites:
        trajs = load_pickle(os.path.join(site_supp_folder(supp_folder, site),
                                         "cell_traj.pkl"))
        for i, t in enumerate(trajs[0]):
            name = site + "/" + str(i)
            traj = [patch_id_mapping[(site, t_point, t[t_point])]
                    for t_point in sorted(t.keys())
                    if (site, t_point, t[t_point]) in patch_id_mapping]
            if len(traj) > 0.95 * len(t):
                site_trajs[name] = traj
    save_pickle(site_trajs,
                os.path.join(summary_folder, f"{well}_trajectories.pkl"))


def zscore_patch_device(x: torch.Tensor) -> torch.Tensor:
    """Per-patch per-channel z-score of an (N, C, H, W) batch on its device
    (``_encode_fn``, dynamorph_tpu/pipeline/patch_vae.py:236-241): the
    biased std (``correction=0``, as ``jnp.std`` and ``np.std``) plus
    float64's eps, as the reference adds it."""
    mean = torch.mean(x, dim=(2, 3), keepdim=True)
    std = torch.std(x, dim=(2, 3), keepdim=True, correction=0)
    return (x - mean) / (std + np.finfo(float).eps)


def encode_batch(model, x: torch.Tensor, batch_size: int,
                 normalize: Optional[str] = None):
    """One encode dispatch: ``x`` (n <= batch_size, C, H, W) float32 on the
    model's device, zero-padded to ``batch_size`` rows so every dispatch
    has one shape -> (z_before (n, D*), z_after (n, D*)) on the device.
    normalize="patch" z-scores each patch (``zscore_patch_device``). The
    staged encode and the streaming one (pipeline/stream.py) share it, so a
    patch meets the same arithmetic on both paths."""
    n = x.shape[0]
    if n < batch_size:
        x = torch.cat([x, x.new_zeros((batch_size - n,) + tuple(x.shape[1:]))])
    if normalize == "patch":
        x = zscore_patch_device(x)
    z_b, z_a, _ = model.encode(x)
    return z_b.reshape(batch_size, -1)[:n], z_a.reshape(batch_size, -1)[:n]


def encode_patches(model, dataset: np.ndarray, batch_size: int = 512,
                   normalize: Optional[str] = None,
                   device: Device = "cuda",
                   devices: Optional[Sequence[torch.device]] = None):
    """Batched encode: (N, C, H, W) -> (z_before (N, D*), z_after (N, D*)),
    float32 numpy, ``encode_batch`` by ``encode_batch`` on ``device`` (the
    model is moved there).

    With two or more ``devices`` (default: this process's cards,
    ``core.mesh.local_devices()``, when ``device`` is the card) each batch
    fans out over them (dynamorph_tpu/pipeline/patch_vae.py:119-150):
    ``batch_size`` is rounded up to a multiple of their count, a batch is
    edge-padded and split into equal chunks (``core.mesh.shard_batch``),
    a replica of the model encodes each chunk on its device, and the
    latents come back in order with the padding trimmed."""
    dev = resolve_device(device)
    if devices is None:
        devices = local_devices() if dev.type == "cuda" else []
    if len(devices) > 1:
        return _encode_fanned_out(model, dataset, batch_size, normalize,
                                  list(devices))
    model.to(dev)
    zbs, zas = [], []
    for i in range(0, len(dataset), batch_size):
        x = torch.from_numpy(np.asarray(dataset[i: i + batch_size],
                                        dtype=np.float32)).to(dev)
        z_b, z_a = encode_batch(model, x, batch_size, normalize)
        zbs.append(z_b)
        zas.append(z_a)
    if not zbs:
        raise ValueError("encode_patches: empty dataset")
    return torch.cat(zbs, 0).cpu().numpy(), torch.cat(zas, 0).cpu().numpy()


def _encode_fanned_out(model, dataset, batch_size, normalize, devices):
    replicas = [replica(model, d) for d in devices]
    batch_size = pad_to_multiple(batch_size, len(devices))
    chunk_rows = batch_size // len(devices)
    zbs, zas = [], []
    for i in range(0, len(dataset), batch_size):
        chunks, n_pad = shard_batch(
            np.asarray(dataset[i: i + batch_size], dtype=np.float32), devices)
        outs = [encode_batch(m, x, chunk_rows, normalize)
                for m, x in zip(replicas, chunks)]
        n = sum(len(x) for x in chunks) - n_pad
        zbs.append(torch.cat([z_b.cpu() for z_b, _ in outs])[:n])
        zas.append(torch.cat([z_a.cpu() for _, z_a in outs])[:n])
    if not zbs:
        raise ValueError("encode_patches: empty dataset")
    return torch.cat(zbs, 0).numpy(), torch.cat(zas, 0).numpy()


def resolve_latent_weights(le):
    """The latent_encoding weights contract: the reference accepts a list of
    weight dirs and uses the first (patch_VAE.py:364-368), a weights DIR
    containing ``model.pt`` loads that file, and latent outputs land under
    ``<raw_folder>/<basename(weights)>/``.

    Returns (weights, model_path, model_name)."""
    weights = le.weights
    if isinstance(weights, (list, tuple)):
        weights = weights[0]
    model_path = weights
    if model_path is not None and os.path.isdir(model_path) and \
            os.path.exists(os.path.join(model_path, "model.pt")):
        model_path = os.path.join(model_path, "model.pt")
    model_name = os.path.basename(os.path.normpath(weights)) \
        if weights else "model"
    return weights, model_path, model_name


def _build_model_from_config(le, num_inputs: int = 2):
    """The configured VQ-VAE family network, built from the keywords it
    takes (``models.registry.build_model``). The JAX package passes the
    VQ-only ``num_embeddings`` and ``commitment_cost`` to every class, so
    its ``process`` cannot build VAE, IWAE or AAE
    (dynamorph_tpu/pipeline/patch_vae.py:194-203)."""
    # num_inputs/num_residual_layers hardcoded in the reference process path
    # (patch_VAE.py:426-429).
    return build_model(le.network, num_inputs=num_inputs,
                       num_hiddens=le.num_hiddens,
                       num_residual_hiddens=le.num_residual_hiddens,
                       num_residual_layers=2,
                       num_embeddings=le.num_embeddings,
                       commitment_cost=le.commitment_cost)


def _load_model_weights(model, weights_path: str):
    """Load a torch ``model.pt`` state_dict into ``model`` (strict), for
    any network: the port's modules carry the reference's names (the JAX
    package imports a ``model.pt`` for the VQ-VAEs only,
    dynamorph_tpu/pipeline/patch_vae.py:206-226)."""
    if os.path.isdir(weights_path):
        raise ValueError(
            f"{weights_path} is a directory without a model.pt; orbax "
            "checkpoint directories need the JAX package — export the model "
            "to a torch model.pt (dynamorph_tpu.models.torch_export)")
    model.load_state_dict(load_reference_checkpoint(weights_path),
                          strict=True)
    return model


def load_well_inputs(raw_folder: str, well: str):
    """Host-side inputs for one well's encode (prefetchable). Static patches
    load from either the pickle or compact (.npz) format, whichever exists."""
    fs = load_pickle(os.path.join(raw_folder, f"{well}_file_paths.pkl"))
    dataset = load_array_any(
        os.path.join(raw_folder, f"{well}_static_patches.pkl"))
    return fs, dataset


def process_vae(raw_folder: str, supp_folder: str, sites: Sequence[str],
                config, batch_size: int = 512, preloaded=None, writer=None,
                device: Device = "cuda",
                devices: Optional[Sequence[torch.device]] = None
                ) -> Dict[str, str]:
    """Encode a well's static patches to latent vectors
    (reference pipeline/patch_VAE.py:343-508), batched on ``device``.

    The VQ-VAE family (VQ_VAE_z16/z32, VAE, IWAE, AAE) z-scores each patch
    on the device and saves ``<well>_latent_space.pkl`` (pre-VQ) and
    ``<well>_latent_space_after.pkl`` (post-VQ; the VAE family's latent
    twice) under ``<raw_folder>/<model_name>/``; with ``save_output`` also
    20 recon JPEGs. A ResNet (``EncodeProject``) z-scores on the host, as
    the JAX package does, and saves the projection ``z`` as
    ``<well>_latent_space.pkl`` only.

    Either branch fans its batches out over ``devices`` (default: this
    process's cards when ``device`` is the card), as ``encode_patches`` and
    ``EncodeProject.encode_batched`` do
    (dynamorph_tpu/pipeline/patch_vae.py:325-339).

    ``preloaded``: optional (fs, dataset) from ``load_well_inputs``.
    ``writer``: optional io.prefetch.AsyncWriter — saves submit to it
    instead of blocking; the caller owns close().
    """
    dev = resolve_device(device)
    le = config.latent_encoding
    _, probed_path, model_name = resolve_latent_weights(le)
    if len({well_of(s) for s in sites}) != 1:
        raise ValueError("Sites should be from a single well/condition")
    well = well_of(sites[0])

    if not is_vae_family(le.network) and "ResNet" not in le.network:
        raise ValueError(f"Network {le.network} is not available")

    fs, dataset = preloaded if preloaded is not None \
        else load_well_inputs(raw_folder, well)
    # squeeze only the stale z axis: a bare np.squeeze (reference
    # patch_VAE.py:419) also drops a singleton batch/channel axis
    if dataset.ndim == 5 and dataset.shape[2] == 1:
        dataset = dataset[:, :, 0]
    else:
        dataset = np.squeeze(dataset)
    if dataset.ndim != 4:
        raise ValueError(f"dataset must be 4-D, got {dataset.ndim}")
    if len(fs) != len(dataset):
        raise ValueError(f"{len(fs)} file paths for {len(dataset)} patches")

    output_dir = os.path.join(raw_folder, model_name)
    os.makedirs(output_dir, exist_ok=True)
    storage = getattr(le, "storage", "pickle")
    put = writer.submit if writer is not None \
        else (lambda fn, *a, **kw: fn(*a, **kw))

    if "ResNet" in le.network:
        # the weights come from the path the JAX branch reads (a model.pt,
        # or a directory holding one)
        model = EncodeProject(arch=le.network)
        _load_model_weights(model, probed_path)
        model.to(dev)
        dataset = zscore_patch(dataset).astype(np.float32)
        with stage_timer("process_vae_encode", well=well, n=len(dataset)):
            z = model.encode_batched(dataset, out="z", batch_size=batch_size,
                                     devices=devices)
        put(save_array, z,
            storage_path(os.path.join(output_dir,
                                      f"{well}_latent_space.pkl"), storage),
            storage=storage)
        return {"output_dir": output_dir}

    model = _build_model_from_config(le, num_inputs=2)
    _load_model_weights(model, probed_path)
    # per-patch z-scoring (reference patch_VAE.py:418) runs on the device
    with stage_timer("process_vae_encode", well=well, n=len(dataset)):
        z_b, z_a = encode_patches(model, dataset, batch_size,
                                  normalize="patch", device=dev,
                                  devices=devices)
    put(save_array, z_b,
        storage_path(os.path.join(output_dir, f"{well}_latent_space.pkl"),
                     storage),
        storage=storage)
    put(save_array, z_a,
        storage_path(
            os.path.join(output_dir, f"{well}_latent_space_after.pkl"),
            storage),
        storage=storage)
    if le.save_output:
        put(_save_recon_images, model, dataset, output_dir, device=dev)
    return {"output_dir": output_dir}


def recon_sample_indices(n_patches: int, n: int = 20) -> np.ndarray:
    """The patches that ``_save_recon_images`` renders: the JAX package's
    draw, ``np.random.RandomState(0).randint(0, n_patches, (n,))``
    (dynamorph_tpu/pipeline/patch_vae.py:366-367), so both packages write
    the same ``recon_<i>.jpg`` names."""
    return np.random.RandomState(0).randint(0, n_patches, (n,))


def _save_recon_images(model, dataset, output_dir, n: int = 20,
                       device: Device = "cuda"):
    """``n`` random reconstruction JPEGs (reference patch_VAE.py:464-489),
    of the patches ``recon_sample_indices`` picks. The VAE and IWAE decode
    their mean latent (``predict``), so the images draw no noise (the
    IWAE's ``apply`` returns no reconstruction).

    Object-oriented matplotlib (no pyplot globals) so it can run on an
    io.prefetch.AsyncWriter thread while the next well encodes."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    from ..io.images import im_adjust

    dev = resolve_device(device)
    model.to(dev)
    reconstruct = model.predict if isinstance(model, VAEModel) \
        else model.apply
    for i in recon_sample_indices(len(dataset), n):
        # dataset arrives raw; per-patch z-score is local to each sample
        sample = zscore_patch(dataset[i: i + 1]).astype(np.float32)
        output, _ = reconstruct(torch.from_numpy(sample).to(dev))
        output = output.cpu().numpy()
        ims = [im_adjust(sample[0, 0]), im_adjust(output[0, 0]),
               im_adjust(sample[0, 1]), im_adjust(output[0, 1])]
        names = ["phase", "phase_recon", "im_retard", "retard_recon"]
        fig = Figure(figsize=(15, 10))
        FigureCanvasAgg(fig)
        for k, (im, name) in enumerate(zip(ims, names)):
            a = fig.add_subplot(2, 2, k + 1)
            a.imshow(np.squeeze(im), cmap="gray")
            a.axis("off")
            a.set_title(name, fontsize=12)
        fig.savefig(os.path.join(output_dir, "recon_%d.jpg" % i),
                    dpi=300, bbox_inches="tight")
