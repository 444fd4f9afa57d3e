"""K-means on the card: the port's own counterpart of sklearn's
``KMeans(n_clusters, random_state=seed, n_init=10)``, which the JAX
package's state clustering calls (dynamorph_tpu/analysis/
state_clustering.py:53, :206). The port may not import sklearn.

The algorithm is sklearn's: the data centred on its mean, greedy
k-means++ seeding (``2 + int(log k)`` candidates a centre, the one that
lowers the potential most kept), Lloyd iterations until the labels stop
changing or the centres move by at most ``TOL`` times the data's mean
variance (squared shift, summed), then a last assignment, and the restart
with the lowest inertia. An emptied cluster takes the point farthest from
its centre.

sklearn's random stream cannot be copied, so the seeding draws its
uniforms from a CPU ``torch.Generator`` seeded with ``seed``: the card and
the CPU draw the same numbers, and their labels differ only where a point
lies within rounding of two centres. Distances are
``|x|^2 - 2 x.c + |c|^2`` (one matrix product and an argmin) in the
input's dtype (float32 without TF32, or float64).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import numpy as np
import torch

from ..core.device import fp32_strict, resolve_device

# sklearn's defaults, as the JAX package's KMeans(n_clusters, random_state,
# n_init=10) runs them
N_INIT = 10
MAX_ITER = 300
TOL = 1e-4


@dataclass
class KMeansResult:
    """The fitted model, with sklearn's attribute names."""
    cluster_centers_: np.ndarray
    labels_: np.ndarray
    inertia_: float
    n_iter_: int


def _sq_dist(x, x_sq, c):
    """(N, K) squared distances from the rows of ``x`` to those of ``c``."""
    with fp32_strict():
        d = torch.addmm(x_sq[:, None] + (c * c).sum(1)[None], x, c.T,
                        alpha=-2.0)
    return d.clamp_(min=0.0)


def _plus_plus(x, x_sq, k, generator):
    """Greedy k-means++ seeding (sklearn's ``_kmeans_plusplus``)."""
    n = len(x)
    trials = 2 + int(np.log(k))

    def uniform(m):
        return torch.rand(m, generator=generator,
                          dtype=torch.float64).to(x.device)

    first = min(int(float(uniform(1)) * n), n - 1)
    centers = [x[first]]
    closest = _sq_dist(x, x_sq, x[first:first + 1])[:, 0]
    pot = closest.sum()
    for _ in range(1, k):
        targets = (uniform(trials) * pot.double()).to(x.dtype)
        ids = torch.searchsorted(torch.cumsum(closest, 0), targets)
        ids = ids.clamp_(max=n - 1)
        cand = torch.minimum(closest[None], _sq_dist(x, x_sq, x[ids]).T)
        pots = cand.sum(1)
        best = int(torch.argmin(pots))
        pot, closest = pots[best], cand[best]
        centers.append(x[ids[best]])
    return torch.stack(centers)


def _update(x, labels, d_min, k):
    """The mean of each cluster; an empty one takes the point farthest
    from its centre."""
    onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)
    with fp32_strict():
        sums = onehot.T @ x
    counts = onehot.sum(0)
    centers = sums / counts.clamp(min=1)[:, None]
    empty = torch.nonzero(counts == 0).flatten()
    if len(empty):
        far = torch.argsort(d_min, descending=True)[:len(empty)]
        centers[empty] = x[far]
    return centers


def _lloyd(x, x_sq, centers, tol):
    """sklearn's ``_kmeans_single_lloyd``: (labels, centers, inertia,
    iterations)."""
    k = len(centers)
    labels_old = None
    strict = False
    for it in range(MAX_ITER):
        d = _sq_dist(x, x_sq, centers)
        d_min, labels = torch.min(d, dim=1)
        new = _update(x, labels, d_min, k)
        shift = float(((new - centers) ** 2).sum())
        centers = new
        if labels_old is not None and torch.equal(labels, labels_old):
            strict = True
            break
        if shift <= tol:
            break
        labels_old = labels
    if not strict:
        d_min, labels = torch.min(_sq_dist(x, x_sq, centers), dim=1)
    else:
        d_min = _sq_dist(x, x_sq, centers).gather(1, labels[:, None])[:, 0]
    return labels, centers, float(d_min.sum()), it + 1


def kmeans(x: np.ndarray, n_clusters: int, seed: int = 0,
           device: Union[str, torch.device] = "cuda") -> KMeansResult:
    """Fit ``n_clusters`` centres to the rows of ``x`` (N, D): ``N_INIT``
    seeded restarts, the lowest inertia kept. Integer input is computed in
    float64, as sklearn converts it."""
    dev = resolve_device(device)
    x = np.asarray(x)
    if x.dtype not in (np.float32, np.float64):
        x = x.astype(np.float64)
    if len(x) < n_clusters:
        raise ValueError(f"n_samples={len(x)} should be >= "
                         f"n_clusters={n_clusters}")
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    mean = xt.mean(dim=0)
    xc = xt - mean
    x_sq = (xc * xc).sum(1)
    tol = TOL * float(torch.var(xt, dim=0, unbiased=False).mean())
    generator = torch.Generator().manual_seed(seed)
    best = None
    for _ in range(N_INIT):
        centers = _plus_plus(xc, x_sq, n_clusters, generator)
        run = _lloyd(xc, x_sq, centers, tol)
        if best is None or run[2] < best[2]:
            best = run
    labels, centers, inertia, n_iter = best
    return KMeansResult(
        cluster_centers_=(centers + mean).cpu().numpy(),
        labels_=labels.cpu().numpy().astype(np.int32),
        inertia_=inertia, n_iter_=n_iter)
