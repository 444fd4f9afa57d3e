"""Reconstruction-quality evaluation over a patch dataset — the port of
``dynamorph_tpu/analysis/recon_eval.py``.

Behavioral spec: reference plot_scripts/recon_loss.py — per-sample
reconstruction losses of a trained VQ-VAE over random patch subsets (the only
quantitative quality numbers recorded in the reference: 0.00756 +/- 0.01691
train / 0.00795 +/- 0.00617 held-out, recon_loss.py:36-37). The reference
evaluates one patch per forward on CPU; here samples run in batches on the
model's device.

The per-sample loss is the channel-variance-scaled MSE of the model's
eval-mode forward (vae.py:319 semantics, batch of 1 == per-sample mean). A
VQ-VAE's eval ``apply`` looks its codes up with the ``vq_lookup`` kernel, one
launch a batch. Batches are not padded: in eval mode each sample's output is
its own, so the last, shorter batch gives what a padded one would.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device


def evaluate_recon_losses(model, dataset: np.ndarray,
                          n_samples: Optional[int] = 5000, seed: int = 123,
                          batch_size: int = 256,
                          device: Union[str, torch.device] = "cuda"
                          ) -> np.ndarray:
    """Per-sample reconstruction losses over a random subset.

    Args:
        model: a VQ-VAE family model (``apply(x, train=False)`` returning
            (decoded, losses)); it is moved to ``device``.
        dataset: (N, C, H, W) float32 patches (already normalised).
        n_samples: subset size (None = all, no sampling).
        seed: RNG seed for the subset draw (reference uses 123).

    Returns:
        (n_samples,) float32 array of per-sample recon losses.
    """
    dev = resolve_device(device)
    if n_samples is not None and n_samples < len(dataset):
        rng = np.random.RandomState(seed)
        idx = rng.choice(np.arange(len(dataset)), (n_samples,), replace=False)
        dataset = dataset[idx]
    model.to(dev)
    cv = model.channel_var.reshape(1, -1, 1, 1)
    out = []
    for i in range(0, len(dataset), batch_size):
        x = torch.from_numpy(np.ascontiguousarray(
            dataset[i: i + batch_size], dtype=np.float32)).to(dev)
        decoded, _ = model.apply(x, train=False)
        out.append(torch.mean((decoded - x) ** 2 / cv, dim=(1, 2, 3)))
    return torch.cat(out).cpu().numpy()


def recon_loss_summary(losses: np.ndarray) -> Tuple[float, float]:
    """(mean, std) in the reference's reporting format."""
    return float(np.mean(losses)), float(np.std(losses))
