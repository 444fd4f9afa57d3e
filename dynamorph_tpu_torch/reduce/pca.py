"""PCA over latent vectors, the SVD on the card — the port of
``dynamorph_tpu/reduce/pca.py``.

Behavioral spec: reference run_dim_reduction.py:14-92 — fit PCA keeping the
top PCs that explain 50% of variance (sklearn `PCA(0.5)`), save
``pca_model.pkl`` + a PC1/PC2 scatter PNG, and transform latent pickles to
``*_PCAed.pkl``.

The fit is one ``torch.linalg.svd`` in fp32 (no TF32) on the device; the
component count is chosen on the host exactly as the JAX package chooses
it. On the card the SVD runs cuSOLVER's ``gesvd`` (Householder
bidiagonalization, LAPACK's method). ``chip_smoke.py`` phase 10 times
and checks the other drivers beside the fit: PyTorch's default, Jacobi
``gesvdj``, leaves fp32 components of a plate's latents about 2e-3 from
orthonormal; ``gesvda`` (tall-skinny) is several times faster and closer
to orthonormal, but raises on rank-deficient latents, which a plate
whose codes or dimensions repeat gives it. The model container, its
pickles (``pca_model.pkl``, a sklearn ``PCA`` written without sklearn)
and ``process_pca`` (the transform, on the host) live in
``reduce/pca_model.py``.

With one card the fit always takes the SVD path, as the JAX package does
on one device; its sharded covariance fit (``fit_pca_distributed``) waits
for the multi-GPU slice.
"""
from __future__ import annotations

import os
from typing import Sequence, Union

import numpy as np
import torch

from ..core.device import fp32_strict, resolve_device
from .pca_model import PCAModel, dumps_sklearn_pca
from .scatter import write_scatter_png

Device = Union[str, torch.device]


def _sign_normalize(components: np.ndarray) -> np.ndarray:
    """Deterministic per-component sign: the max-|value| element of each row
    is made positive."""
    flips = np.sign(components[np.arange(len(components)),
                               np.argmax(np.abs(components), axis=1)])
    flips[flips == 0] = 1.0
    return components * flips[:, None]


def svd_driver(device: torch.device):
    """The ``torch.linalg.svd`` driver of the fit: cuSOLVER's ``gesvd`` on
    the card (the one that is orthonormal in fp32 and takes rank-deficient
    input); on the CPU the argument must be None (LAPACK)."""
    return "gesvd" if device.type == "cuda" else None


def fit_pca_device(train_data, variance_fraction: float = 0.5,
                   device: Device = "cuda") -> PCAModel:
    """Economy SVD in fp32 on ``device``; keep the smallest k with
    cumulative explained variance ratio > variance_fraction (sklearn
    PCA(0.5) semantics). ``train_data``: (n, d), a numpy array or a tensor
    (which may already be on the device)."""
    dev = resolve_device(device)
    X = torch.as_tensor(train_data, dtype=torch.float32, device=dev)
    n = X.shape[0]
    with fp32_strict():
        mean = X.mean(dim=0)
        _, s, vt = torch.linalg.svd(X - mean, full_matrices=False,
                                    driver=svd_driver(dev))
        explained_variance = s * s / (n - 1)
        ratio = explained_variance / explained_variance.sum()
    ratio = ratio.cpu().numpy()
    csum = np.cumsum(ratio)
    k = int(np.searchsorted(csum, variance_fraction, side="right") + 1)
    k = min(k, len(csum))
    return PCAModel(
        components=_sign_normalize(vt[:k].cpu().numpy()),
        mean=mean.cpu().numpy(),
        explained_variance=explained_variance[:k].cpu().numpy(),
        explained_variance_ratio=ratio[:k],
    )


def fit_pca(train_data: np.ndarray, weights_dir: str, labels,
            conditions: Sequence[str], variance_fraction: float = 0.5,
            device: Device = "cuda") -> PCAModel:
    """Fit + save pca_model.pkl + PCA.png scatter (reference
    run_dim_reduction.py:14-51). ``conditions`` named the legend of the JAX
    package's figure; the port's figure has no text."""
    os.makedirs(weights_dir, exist_ok=True)
    pca = fit_pca_device(train_data, variance_fraction, device=device)
    pcas = pca.transform(train_data)
    with open(os.path.join(weights_dir, "pca_model.pkl"), "wb") as f:
        f.write(dumps_sklearn_pca(pca, len(train_data)))
    # fewer than 2 retained PCs: plot PC1 vs zeros
    pc2 = pcas[:, 1] if pcas.shape[1] > 1 else np.zeros(len(pcas))
    write_scatter_png(os.path.join(weights_dir, "PCA.png"),
                      [(pcas[:, 0], pc2)], labels)
    return pca
