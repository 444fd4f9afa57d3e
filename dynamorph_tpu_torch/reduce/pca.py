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

With one card the fit takes the SVD path, as the JAX package does on one
device; with more (``core.mesh.local_devices``) it takes
``fit_pca_distributed``, the covariance's eigendecomposition with the Gram
accumulation sharded over the cards (dynamorph_tpu/reduce/pca.py:106-150).
"""
from __future__ import annotations

import os
from typing import Sequence, Union

import numpy as np
import torch

from ..core.device import fp32_strict, resolve_device
from ..core.mesh import local_devices, shard_batch
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


def _select_k(explained_variance: np.ndarray, variance_fraction: float):
    ratio = explained_variance / max(explained_variance.sum(), 1e-30)
    k = int(np.searchsorted(np.cumsum(ratio), variance_fraction,
                            side="right") + 1)
    return min(k, len(ratio)), ratio


def fit_pca_distributed(train_data, variance_fraction: float = 0.5,
                        devices=None) -> PCAModel:
    """PCA from the covariance's eigendecomposition, with the Gram
    accumulation sharded over ``devices`` (default: this process's
    ``local_devices()``): the rows go out in equal edge-padded chunks
    (``core.mesh.shard_batch``), a weight vector masks the padding rows out
    of the statistics, each device sums its rows and forms its chunk's
    Gram matrix in fp32, and the first device adds them and takes
    ``torch.linalg.eigh`` of the (D, D) covariance. Equal to the SVD path's
    components up to sign (both are sign-normalised). With fewer than two
    devices it is ``fit_pca_device`` on the one given (the card when none
    is), as the JAX package falls back on one device."""
    devices = local_devices() if devices is None else list(devices)
    if len(devices) < 2:
        return fit_pca_device(train_data, variance_fraction,
                              device=devices[0] if devices else "cuda")
    x = np.asarray(train_data, np.float32)
    n, d = x.shape
    chunks, n_pad = shard_batch(x, devices)
    w = np.ones(n + n_pad, np.float32)
    w[n:] = 0.0
    weights, _ = shard_batch(w, devices)
    home = devices[0]
    with fp32_strict():
        total = sum(float(wi.sum()) for wi in weights)
        mean = sum((xi * wi[:, None]).sum(0).to(home)
                   for xi, wi in zip(chunks, weights)) / total
        cov = sum(_weighted_gram(xi, wi, mean.to(xi.device)).to(home)
                  for xi, wi in zip(chunks, weights)) / (total - 1)
        evals, evecs = torch.linalg.eigh(cov)        # ascending
    evals = np.maximum(evals.cpu().numpy()[::-1], 0.0)
    evecs = evecs.cpu().numpy()[:, ::-1].T           # rows = components
    k, ratio = _select_k(evals, variance_fraction)
    return PCAModel(components=_sign_normalize(np.ascontiguousarray(
                        evecs[:k])),
                    mean=mean.cpu().numpy(),
                    explained_variance=evals[:k].copy(),
                    explained_variance_ratio=ratio[:k])


def _weighted_gram(x, w, mean):
    xc = (x - mean) * w[:, None]
    return xc.T @ xc


def fit_pca(train_data: np.ndarray, weights_dir: str, labels,
            conditions: Sequence[str], variance_fraction: float = 0.5,
            device: Device = "cuda") -> PCAModel:
    """Fit + save pca_model.pkl + PCA.png scatter (reference
    run_dim_reduction.py:14-51). ``conditions`` named the legend of the JAX
    package's figure; the port's figure has no text."""
    os.makedirs(weights_dir, exist_ok=True)
    dev = resolve_device(device)
    if dev.type == "cuda" and len(local_devices()) > 1:
        pca = fit_pca_distributed(train_data, variance_fraction)
    else:
        pca = fit_pca_device(train_data, variance_fraction, device=dev)
    pcas = pca.transform(train_data)
    with open(os.path.join(weights_dir, "pca_model.pkl"), "wb") as f:
        f.write(dumps_sklearn_pca(pca, len(train_data)))
    # fewer than 2 retained PCs: plot PC1 vs zeros
    pc2 = pcas[:, 1] if pcas.shape[1] > 1 else np.zeros(len(pcas))
    write_scatter_png(os.path.join(weights_dir, "PCA.png"),
                      [(pcas[:, 0], pc2)], labels)
    return pca
