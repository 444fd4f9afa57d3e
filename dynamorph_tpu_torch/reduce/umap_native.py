"""Native UMAP fit — the port of ``dynamorph_tpu/reduce/umap_native.py``.

The reference's UMAP stage calls ``umap.UMAP(a, b, n_neighbors)
.fit_transform`` over a parameter grid (reference run_dim_reduction.py:
143-207, fit-only). umap-learn is absent from the card's machine, so this
module implements the algorithm (McInnes, Healy & Melville 2018) as the
JAX package does:

1. exact kNN on the device by blocked ``‖x‖² − 2xyᵀ + ‖y‖²`` (fp32, no
   TF32) and ``torch.topk``;
2. the fuzzy simplicial set on the host (numpy, scipy): per-point ``rho``
   and ``sigma`` by vectorized bisection, t-conorm symmetrization
   ``P = W + Wᵀ − W∘Wᵀ``;
3. spectral initialization on the host (scipy ``eigsh`` with
   ``which="SM"``), with the Lanczos basis ``ncv`` clamped to ``n`` (the
   JAX package does not clamp it, so its ``eigsh`` raises below 7 points
   and it takes the fallback); PCA of the graph as the fallback up to 4096
   points, a random box beyond;
4. batched negative-sampling SGD on the device: every directed edge's
   attractive gradient scaled by its weight and ``negative_sample_rate``
   repulsive gradients per edge head, clipped to ±4 per dimension, with
   the linearly decaying learning rate.

Determinism: the negatives come from a ``torch.Generator`` seeded with
``random_state`` on the device, and the per-point gradient sums are
segment sums over edges sorted once by target point, with no atomics, so
a seed gives the same embedding bit for bit on the same device. The
negatives are not the JAX package's (``jax.random`` has its own stream):
``_optimize`` takes them as an argument, so tests can feed the JAX ones.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.device import fp32_strict, resolve_device

Device = Union[str, torch.device]

log = logging.getLogger(__name__)

_SMOOTH_K_TOL = 1e-5
_BISECT_ITERS = 64
_GRAD_CLIP = 4.0
_DENSE_FALLBACK_MAX = 4096


def find_ab_params(spread: float = 1.0, min_dist: float = 0.1
                   ) -> Tuple[float, float]:
    """Fit the differentiable curve 1/(1 + a d^{2b}) to the desired
    exp-falloff membership (umap-learn's find_ab_params)."""
    from scipy.optimize import curve_fit

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.zeros_like(xv)
    yv[xv < min_dist] = 1.0
    yv[xv >= min_dist] = np.exp(-(xv[xv >= min_dist] - min_dist) / spread)
    params, _ = curve_fit(curve, xv, yv)
    return float(params[0]), float(params[1])


def knn_graph(x: np.ndarray, n_neighbors: int, block: int = 1024,
              device: Device = "cuda"):
    """Exact kNN (excluding self) on ``device``: returns (indices,
    distances) of shape (N, k), int64 and float64. Distances are
    Euclidean. Blocked so the (block, N) distance tile — not the full N²
    matrix — is the working set."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    n = len(x)
    k = min(n_neighbors, n - 1)
    sq_h = (x * x).sum(axis=1)
    xd = torch.from_numpy(x).to(dev)
    sq = torch.from_numpy(sq_h).to(dev)
    inds = np.empty((n, k), np.int64)
    dists = np.empty((n, k), np.float64)
    for s in range(0, n, block):
        e = min(s + block, n)
        with fp32_strict():
            d2 = sq[s:e, None] - 2.0 * xd[s:e] @ xd.T + sq[None, :]
        d2, idx = torch.topk(d2, k + 1, dim=1, largest=False, sorted=True)
        d2 = np.maximum(d2.cpu().numpy().astype(np.float64), 0.0)
        idx = idx.cpu().numpy()
        # drop self (distance-0 column; fall back to masking by index in
        # case of exact duplicates putting self later in the tie order)
        keep = idx != np.arange(s, e)[:, None]
        all_kept = keep.sum(axis=1) > k  # self never matched (duplicates)
        keep[all_kept, -1] = False
        inds[s:e] = idx[keep].reshape(-1, k)
        dists[s:e] = d2[keep].reshape(-1, k)
    return inds, np.sqrt(dists)


def smooth_knn(dists: np.ndarray, local_connectivity: float = 1.0
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-point (rho, sigma): rho = distance to the nearest (nonzero)
    neighbor; sigma solved by bisection so
    sum_j exp(-max(0, d_ij - rho_i)/sigma_i) = log2(k)."""
    n, k = dists.shape
    target = np.log2(k)
    nonzero_counts = (dists > 0).sum(axis=1)
    # rows are sorted ascending, so zeros (exact duplicates) all precede
    # the nonzero distances
    first_nz = (dists > 0).argmax(axis=1)
    pos = first_nz if local_connectivity <= 1 else np.minimum(
        first_nz + int(local_connectivity) - 1, k - 1)
    rho = np.where(nonzero_counts > 0, dists[np.arange(n), pos], 0.0)
    lo = np.zeros(n)
    hi = np.full(n, np.inf)
    mid = np.ones(n)
    d_shift = np.maximum(dists - rho[:, None], 0.0)
    for _ in range(_BISECT_ITERS):
        psum = np.exp(-d_shift / mid[:, None]).sum(axis=1)
        err = psum - target
        if np.all(np.abs(err) < _SMOOTH_K_TOL):
            break
        too_high = err > 0
        hi = np.where(too_high, mid, hi)
        lo = np.where(too_high, lo, mid)
        mid = np.where(too_high, (lo + hi) / 2,
                       np.where(np.isinf(hi), mid * 2, (lo + hi) / 2))
    # umap's MIN_K_DIST_SCALE floor against degenerate all-equal rows
    mean_d = dists.mean() or 1.0
    sigma = np.maximum(mid, 1e-3 * mean_d)
    sigma[nonzero_counts == 0] = 1.0
    return rho, sigma


def fuzzy_from_knn(inds: np.ndarray, dists: np.ndarray):
    """kNN -> memberships -> t-conorm symmetrization: a scipy.sparse CSR
    of pairwise membership strengths."""
    from scipy import sparse

    rho, sigma = smooth_knn(dists)
    w = np.exp(-np.maximum(dists - rho[:, None], 0.0) / sigma[:, None])
    n, k = inds.shape
    rows = np.repeat(np.arange(n), k)
    mat = sparse.coo_matrix((w.ravel(), (rows, inds.ravel())),
                            shape=(n, n)).tocsr()
    t = mat.T.tocsr()
    prod = mat.multiply(t)
    return (mat + t - prod).tocsr()


def fuzzy_simplicial_set(x: np.ndarray, n_neighbors: int,
                         device: Device = "cuda"):
    """The kNN graph on ``device``, then ``fuzzy_from_knn`` on the host."""
    return fuzzy_from_knn(*knn_graph(x, n_neighbors, device=device))


def spectral_init(graph, n_components: int, seed: int
                  ) -> Tuple[np.ndarray, str]:
    """Symmetric-normalized-Laplacian eigenvectors (umap's 'spectral'
    init), scaled to the ±10 box with a little noise; returns the float32
    embedding and which init ran: "spectral", "pca" (the eigensolver
    failed, up to 4096 points: PCA of the densified graph) or "random"
    (it failed beyond: a deterministic uniform box)."""
    from scipy import sparse
    from scipy.sparse import linalg as slinalg

    n = graph.shape[0]
    rng = np.random.RandomState(seed)
    k = n_components + 1
    try:
        deg = np.asarray(graph.sum(axis=1)).ravel()
        d_inv = sparse.diags(1.0 / np.sqrt(np.maximum(deg, 1e-12)))
        lap = sparse.identity(n) - d_inv @ graph @ d_inv
        ncv = min(n, max(2 * k + 1, int(np.sqrt(n))))
        _, vecs = slinalg.eigsh(lap, k=k, which="SM", ncv=ncv, tol=1e-4,
                                maxiter=n * 5,
                                v0=np.ones(n) / np.sqrt(n))
        emb, kind = vecs[:, 1:k], "spectral"
    except Exception as e:  # ArpackNoConvergence and friends
        if n <= _DENSE_FALLBACK_MAX:
            log.warning("spectral init failed (%s); PCA fallback", e)
            dense = np.asarray(graph.todense())
            dense -= dense.mean(axis=0)
            _, _, vt = np.linalg.svd(dense, full_matrices=False)
            emb, kind = dense @ vt[:n_components].T, "pca"
        else:
            log.warning("spectral init failed (%s) at n=%d; random box "
                        "fallback (densifying would be O(N^2) memory)",
                        e, n)
            emb = rng.uniform(-10.0, 10.0, size=(n, n_components))
            kind = "random"
    log.info("UMAP init: %s (n=%d)", kind, n)
    expansion = 10.0 / max(np.abs(emb).max(), 1e-12)
    emb = emb * expansion
    emb = (emb + rng.normal(scale=1e-4, size=emb.shape)).astype(np.float32)
    return emb, kind


def _segment_plan(targets: torch.Tensor, n: int):
    """The order that sorts ``targets`` (stable) and each point's count:
    the segment sums over that order are the scatter-adds, in a fixed
    order."""
    order = torch.argsort(targets, stable=True)
    counts = torch.bincount(targets, minlength=n)
    return order, counts


def _epoch(emb, i: int, n_epochs: int, heads, tails, wts, hrep, wrep,
           negs, order, counts, a, b, learning_rate: float):
    """One epoch of the batched SGD; ``negs``: the epoch's
    ``len(heads) * negative_sample_rate`` negative samples."""
    alpha = np.float32(learning_rate) * (
        np.float32(1.0) - np.float32(i) / np.float32(n_epochs))
    diff = emb.index_select(0, heads) - emb.index_select(0, tails)
    d2 = torch.sum(diff * diff, dim=1, keepdim=True)
    d2c = torch.clamp(d2, min=1e-12)
    g = -2.0 * a * b * torch.pow(d2c, b - 1.0) / (1.0 + a * torch.pow(d2c, b))
    g_att = torch.clamp(g * diff, -_GRAD_CLIP, _GRAD_CLIP) * wts

    diff_n = emb.index_select(0, hrep) - emb.index_select(0, negs)
    d2n = torch.sum(diff_n * diff_n, dim=1, keepdim=True)
    g = 2.0 * b / ((0.001 + d2n) * (1.0 + a * torch.pow(
        torch.clamp(d2n, min=1e-12), b)))
    not_self = (hrep != negs)[:, None]
    g_rep = torch.clamp(g * diff_n, -_GRAD_CLIP, _GRAD_CLIP) * not_self * wrep

    values = torch.cat([g_att, -g_att, g_rep]).index_select(0, order)
    # the lengths are the targets' bincount, so they cover the rows; unsafe
    # skips a check that would wait for the device every epoch
    upd = torch.segment_reduce(values, "sum", lengths=counts, axis=0,
                               unsafe=True)
    return emb + float(alpha) * upd


def _optimize(emb0, heads, tails, weights, a, b, n_epochs,
              negative_sample_rate, learning_rate, seed,
              device: Device = "cuda",
              negatives: Optional[Sequence[np.ndarray]] = None
              ) -> np.ndarray:
    """Batched negative-sampling SGD (see the module docstring, item 4) on
    ``device``. ``negatives``: one index array a epoch to use instead of
    the seeded draws (tests feed the JAX package's)."""
    dev = resolve_device(device)
    n = emb0.shape[0]
    heads = torch.as_tensor(np.asarray(heads, np.int64), device=dev)
    tails = torch.as_tensor(np.asarray(tails, np.int64), device=dev)
    wts = torch.as_tensor(np.asarray(weights / weights.max(), np.float32),
                          device=dev)[:, None]
    hrep = torch.repeat_interleave(heads, negative_sample_rate)
    wrep = torch.repeat_interleave(wts, negative_sample_rate, dim=0)
    order, counts = _segment_plan(torch.cat([heads, tails, hrep]), n)
    a = torch.tensor(a, dtype=torch.float32, device=dev)
    b = torch.tensor(b, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    emb = torch.as_tensor(np.asarray(emb0, np.float32), device=dev)
    for i in range(n_epochs):
        if negatives is None:
            negs = torch.randint(0, n, (len(hrep),), generator=gen,
                                 device=dev)
        else:
            negs = torch.as_tensor(np.asarray(negatives[i], np.int64),
                                   device=dev)
        emb = _epoch(emb, i, n_epochs, heads, tails, wts, hrep, wrep, negs,
                     order, counts, a, b, learning_rate)
    return emb.cpu().numpy()


class NativeUMAP:
    """The slice of ``umap.UMAP`` (umap-learn>=0.5.1) the pipeline uses:
    keyword construction with ``a``/``b``/``n_neighbors``, and
    ``fit_transform(X) -> (N, 2)``.
    Fit-only, like the reference stage. After a fit, ``init_`` names the
    init that ran and ``timings_`` holds the seconds of each step."""

    def __init__(self, a: Optional[float] = None, b: Optional[float] = None,
                 n_neighbors: int = 15, n_components: int = 2,
                 min_dist: float = 0.1, spread: float = 1.0,
                 n_epochs: Optional[int] = None,
                 negative_sample_rate: int = 5, learning_rate: float = 1.0,
                 random_state: int = 0, device: Device = "cuda"):
        if (a is None) != (b is None):
            raise ValueError("a and b must be given together (the "
                             "umap-learn contract)")
        if a is None:
            a, b = find_ab_params(spread, min_dist)
        self.a, self.b = float(a), float(b)
        self.n_neighbors = int(n_neighbors)
        self.n_components = int(n_components)
        self.n_epochs = n_epochs
        self.negative_sample_rate = int(negative_sample_rate)
        self.learning_rate = float(learning_rate)
        self.random_state = int(random_state)
        self.device = resolve_device(device)
        self.embedding_ = None
        self.init_: Optional[str] = None
        self.timings_: Dict[str, float] = {}

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if x.ndim != 2:
            raise ValueError(f"expected (N, D) data, got {x.shape}")
        n = len(x)
        if n <= self.n_components + 1:
            raise ValueError(f"need more than {self.n_components + 1} "
                             f"samples, got {n}")
        t0 = time.perf_counter()
        inds, dists = knn_graph(x, self.n_neighbors, device=self.device)
        t1 = time.perf_counter()
        graph = fuzzy_from_knn(inds, dists)
        t2 = time.perf_counter()
        n_epochs = self.n_epochs or (500 if n <= 10000 else 200)
        # umap drops edges too weak to ever fire within the epoch budget
        keep = graph.data >= graph.data.max() / float(n_epochs)
        coo = graph.tocoo()
        heads, tails, wts = (coo.row[keep], coo.col[keep], coo.data[keep])
        emb0, self.init_ = spectral_init(graph, self.n_components,
                                         self.random_state)
        t3 = time.perf_counter()
        self.embedding_ = _optimize(
            emb0, heads, tails, wts, self.a, self.b, n_epochs,
            self.negative_sample_rate, self.learning_rate,
            self.random_state, device=self.device)
        t4 = time.perf_counter()
        self.timings_ = {"knn_s": t1 - t0, "fuzzy_s": t2 - t1,
                         "init_s": t3 - t2, "optimize_s": t4 - t3,
                         "n_edges": int(len(heads)), "n_epochs": n_epochs}
        return self.embedding_
