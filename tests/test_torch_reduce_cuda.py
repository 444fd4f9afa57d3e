"""Dimensionality reduction on the card against the port's CPU path: the
PCA fit (cuSOLVER's gesvd against LAPACK), the UMAP kNN graph, one SGD
epoch on the same negatives, and the bit-for-bit repeat of a whole native
UMAP fit on the card.

Limits, from fp32: PCA components within 1e-4 after sign normalisation
and orthonormal within 1e-5, explained variances within 1e-4 relative;
kNN index sets equal where the k-th and (k+1)-th distances are apart by
more than the rounding of the squared-distance formula, distances within
1e-5 relative; one epoch within 1e-4 (pow and the sums round differently
on the two devices).

This file imports neither jax nor the JAX package, so it also runs on a GPU
host without them: ``python -m pytest --noconftest
tests/test_torch_reduce_cuda.py``. Without a card every test skips.
"""
import numpy as np
import pytest
import torch

from dynamorph_tpu_torch.reduce.pca import fit_pca_device
from dynamorph_tpu_torch.reduce.umap_native import (NativeUMAP, _optimize,
                                                    fuzzy_from_knn,
                                                    knn_graph,
                                                    spectral_init)

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares the card with the CPU")
    return torch.device("cuda")


def _latents(n=4608, d=4096, rank=32, seed=0):
    """z16-length latents: a decaying spectrum of ``rank`` factors, noise
    and an offset, entries of std about 0.2."""
    r = np.random.RandomState(seed)
    z = (r.randn(n, rank) * 0.9 ** np.arange(rank)) @ (0.1 * r.randn(rank, d))
    return (z + 0.02 * r.randn(n, d) + 0.05).astype(np.float32)


@pytest.mark.cuda
def test_pca_fit_card_matches_cpu(cuda):
    x = _latents()
    card = fit_pca_device(x, device=cuda)
    cpu = fit_pca_device(x, device="cpu")
    assert card.n_components_ == cpu.n_components_ >= 2
    c = card.components_.astype(np.float64)
    assert np.abs(c @ c.T - np.eye(len(c))).max() <= 1e-5
    np.testing.assert_allclose(card.components_, cpu.components_, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(card.mean_, cpu.mean_, rtol=0, atol=1e-6)
    np.testing.assert_allclose(card.explained_variance_,
                               cpu.explained_variance_, rtol=1e-4)


@pytest.mark.cuda
def test_knn_graph_card_matches_cpu(cuda):
    x = _latents(n=2048)
    ic, dc = knn_graph(x, 15, device=cuda)
    ih, dh = knn_graph(x, 15, device="cpu")
    x64 = x.astype(np.float64)
    sq = (x64 * x64).sum(1)
    d2 = sq[:, None] - 2 * x64 @ x64.T + sq[None]
    np.fill_diagonal(d2, np.inf)
    kth = np.sort(d2, 1)
    clear = kth[:, 15] - kth[:, 14] > 16 * EPS32 * sq.max()
    assert clear.mean() > 0.9
    # neighbours within a row may swap places at near-equal distances
    np.testing.assert_array_equal(np.sort(ic[clear], 1),
                                  np.sort(ih[clear], 1))
    np.testing.assert_allclose(np.sort(dc, 1), np.sort(dh, 1), rtol=1e-5)


@pytest.mark.cuda
def test_umap_epoch_card_matches_cpu_and_fit_repeats(cuda):
    x = _latents(n=1500, rank=8)
    inds, dists = knn_graph(x, 15, device="cpu")
    graph = fuzzy_from_knn(inds, dists)
    coo = graph.tocoo()
    emb0, _ = spectral_init(graph, 2, 0)
    negs = [np.random.RandomState(1).randint(0, len(x), 5 * coo.nnz)]
    args = (emb0, coo.row, coo.col, coo.data, 1.58, 0.9, 1, 5, 1.0, 0)
    card = _optimize(*args, device=cuda, negatives=negs)
    cpu = _optimize(*args, device="cpu", negatives=negs)
    assert np.abs(cpu - emb0).max() > 1.0
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-4)
    fits = [NativeUMAP(a=1.58, b=0.9, n_neighbors=15, n_epochs=100,
                       device=cuda).fit_transform(x) for _ in range(2)]
    np.testing.assert_array_equal(fits[0], fits[1])
