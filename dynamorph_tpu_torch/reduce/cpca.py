"""Contrastive PCA over latent vectors, on the card — the port of
``dynamorph_tpu/reduce/cpca.py``.

Behavioral spec: reference HiddenStateExtractor/deprecated/cpca.py (which
delegated to the external `contrastive` package): find directions that
maximise target-set variance relative to background-set variance —
eigenvectors of C_target - alpha * C_background (Abid et al., Nat. Comm.
2018), one eigendecomposition per alpha, with the package's log-spaced
alpha spectrum.

As in the JAX package, both covariances are float64 and each
``C_t - alpha * C_b`` is decomposed in float32 (``torch.linalg.eigh``,
cuSOLVER on the card). An eigenvector is defined up to its sign, and only
where its eigenvalue stands clear of its neighbours: inside a cluster of
eigenvalues closer than fp32 rounding, any basis of the cluster's subspace
is as good an answer.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.device import fp32_strict, resolve_device


def _cov(x: torch.Tensor) -> torch.Tensor:
    xc = x - x.mean(dim=0)
    return (xc.T @ xc) / max(len(x) - 1, 1)


def covariances(target, background, device: Union[str, torch.device] = "cuda"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float64 covariances (D, D) of both sets, on ``device``."""
    dev = resolve_device(device)

    def cov(a):
        return _cov(torch.as_tensor(np.asarray(a)).to(dev, torch.float64))

    return cov(target), cov(background)


def fit_cpca(target: np.ndarray, background: np.ndarray,
             n_components: int = 2,
             alphas: Sequence[float] = (0.0, 1.0, 10.0, 100.0),
             device: Union[str, torch.device] = "cuda"
             ) -> List[Tuple[float, np.ndarray, np.ndarray]]:
    """For each alpha: top eigenvectors of C_target - alpha*C_background.

    Returns a list of (alpha, components (k, D) float32, projected target
    (N, k)), numpy arrays as the JAX package returns them. The projection
    is the centred target in its own dtype times the components' transpose,
    with no TF32.
    """
    dev = resolve_device(device)
    c_t, c_b = covariances(target, background, dev)
    t = torch.as_tensor(np.asarray(target)).to(dev)
    t_centered = t - t.mean(dim=0)
    out = []
    for alpha in alphas:
        w, v = torch.linalg.eigh((c_t - alpha * c_b).to(torch.float32))
        order = torch.argsort(w, descending=True)[:n_components]
        components = v[:, order].T                  # (k, D)
        with fp32_strict():
            projected = t_centered @ components.T.to(t_centered.dtype)
        out.append((float(alpha), components.cpu().numpy(),
                    projected.cpu().numpy()))
    return out


def auto_alphas(max_log_alpha: float = 3.0, n_alphas: int = 4
                ) -> np.ndarray:
    """Log-spaced alpha spectrum like the contrastive package's defaults."""
    return np.concatenate([[0.0], np.logspace(-1, max_log_alpha,
                                              n_alphas - 1)])
