"""Latent encoding of a well's static patches — the port of the VAE branch
of ``dynamorph_tpu/pipeline/patch_vae.py::process_vae`` (reference
pipeline/patch_VAE.py:343-508, ``run_VAE -m process``).

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
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.profiling import stage_timer
from ..io.compact import load_array_any, save_array, storage_path
from ..io.pickles import load_pickle
from ..io.sites import well_of
from ..models.jax_import import load_reference_checkpoint
from ..models.registry import get_model_cls
from ..train.data import zscore_patch

log = logging.getLogger(__name__)

Device = Union[str, torch.device]


def zscore_patch_device(x: torch.Tensor) -> torch.Tensor:
    """Per-patch per-channel z-score of an (N, C, H, W) batch on its device
    (``_encode_fn``, dynamorph_tpu/pipeline/patch_vae.py:236-241): the
    biased std (``correction=0``, as ``jnp.std`` and ``np.std``) plus
    float64's eps, as the reference adds it."""
    mean = torch.mean(x, dim=(2, 3), keepdim=True)
    std = torch.std(x, dim=(2, 3), keepdim=True, correction=0)
    return (x - mean) / (std + np.finfo(float).eps)


def encode_patches(model, dataset: np.ndarray, batch_size: int = 512,
                   normalize: Optional[str] = None,
                   device: Device = "cuda"):
    """Batched encode: (N, C, H, W) -> (z_before (N, D*), z_after (N, D*)),
    float32 numpy.

    The model is moved to ``device``. The trailing batch is zero-padded to
    ``batch_size`` so every batch has one shape. normalize="patch" z-scores
    each patch on the device (``zscore_patch_device``).
    """
    dev = resolve_device(device)
    model.to(dev)
    n = len(dataset)
    zbs, zas = [], []
    for i in range(0, n, batch_size):
        batch = np.asarray(dataset[i: i + batch_size], dtype=np.float32)
        if len(batch) < batch_size:
            pad = batch_size - len(batch)
            batch = np.concatenate(
                [batch, np.zeros((pad,) + batch.shape[1:], batch.dtype)], 0)
        x = torch.from_numpy(batch).to(dev)
        if normalize == "patch":
            x = zscore_patch_device(x)
        z_b, z_a, _ = model.encode(x)
        zbs.append(z_b.reshape(batch_size, -1))
        zas.append(z_a.reshape(batch_size, -1))
    if not zbs:
        raise ValueError("encode_patches: empty dataset")
    z_b = torch.cat(zbs, 0)[:n].cpu().numpy()
    z_a = torch.cat(zas, 0)[:n].cpu().numpy()
    return z_b, z_a


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
    cls = get_model_cls(le.network)
    # num_inputs/num_residual_layers hardcoded in the reference process path
    # (patch_VAE.py:426-429).
    return cls(num_inputs=num_inputs,
               num_hiddens=le.num_hiddens,
               num_residual_hiddens=le.num_residual_hiddens,
               num_residual_layers=2,
               num_embeddings=le.num_embeddings,
               commitment_cost=le.commitment_cost)


def _load_model_weights(model, weights_path: str):
    """Load a torch ``model.pt`` state_dict into ``model`` (strict)."""
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
                device: Device = "cuda") -> Dict[str, str]:
    """Encode a well's static patches to latent vectors
    (reference pipeline/patch_VAE.py:343-508), batched on ``device``.

    Saves ``<well>_latent_space.pkl`` (pre-VQ) and
    ``<well>_latent_space_after.pkl`` (post-VQ) under
    ``<raw_folder>/<model_name>/``; with ``save_output`` also 20 recon JPEGs.

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

    if "ResNet" in le.network:
        raise NotImplementedError(
            "the ResNet branch of process_vae comes with ROADMAP slice E "
            "(other model families)")
    if "VAE" not in le.network:
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

    model = _build_model_from_config(le, num_inputs=2)
    _load_model_weights(model, probed_path)
    # per-patch z-scoring (reference patch_VAE.py:418) runs on the device
    with stage_timer("process_vae_encode", well=well, n=len(dataset)):
        z_b, z_a = encode_patches(model, dataset, batch_size,
                                  normalize="patch", device=dev)
    storage = getattr(le, "storage", "pickle")
    put = writer.submit if writer is not None \
        else (lambda fn, *a, **kw: fn(*a, **kw))
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
    of the patches ``recon_sample_indices`` picks.

    Object-oriented matplotlib (no pyplot globals) so it can run on an
    io.prefetch.AsyncWriter thread while the next well encodes."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    from ..io.images import im_adjust

    dev = resolve_device(device)
    model.to(dev)
    for i in recon_sample_indices(len(dataset), n):
        # dataset arrives raw; per-patch z-score is local to each sample
        sample = zscore_patch(dataset[i: i + 1]).astype(np.float32)
        output, _ = model.apply(torch.from_numpy(sample).to(dev))
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
