"""The work after the latents on the card against the CPU: the port's
k-means (labels equal, but at a float64 near-tie of two centres),
``fit_cpca`` (covariances within 1e-12 relative; components, sign-aligned,
|cos| >= 1 - 1e-4 where the float64 eigengap is at least 1e-3 of the
largest |w|) and ``evaluate_recon_losses`` of a VQ-VAE (one ``vq_lookup``
launch a batch; per-sample losses within 1e-5 relative where no code
flips).

This file imports neither jax nor the JAX package, so it also runs on a GPU
host without them:
``python -m pytest --noconftest tests/test_torch_analysis_cuda.py``.
Without a card every test skips.
"""
import numpy as np
import pytest
import torch

from dynamorph_tpu_torch.analysis.kmeans import kmeans
from dynamorph_tpu_torch.analysis.recon_eval import evaluate_recon_losses
from dynamorph_tpu_torch.models import VQVAEz16
from dynamorph_tpu_torch.ops import vq
from dynamorph_tpu_torch.reduce.cpca import covariances, fit_cpca

NEAR_TIE_REL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares the card with the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kmeans_card_vs_cpu(cuda, dtype):
    r = np.random.RandomState(0)
    centers = r.randn(6, 10) * 3
    x = np.concatenate([c + r.randn(2000, 10) for c in centers]).astype(dtype)
    card = kmeans(x, 6, seed=1, device=cuda)
    cpu = kmeans(x, 6, seed=1, device="cpu")
    diff = np.nonzero(card.labels_ != cpu.labels_)[0]
    c = cpu.cluster_centers_.astype(np.float64)
    for i in diff:
        xi = x[i].astype(np.float64)
        a, b = c[cpu.labels_[i]], c[card.labels_[i]]
        gap = abs(((xi - a) ** 2).sum() - ((xi - b) ** 2).sum())
        assert gap <= NEAR_TIE_REL * (xi @ xi + max(a @ a, b @ b)), i
    assert len(diff) <= 0.001 * len(x)
    assert card.inertia_ == pytest.approx(cpu.inertia_, rel=1e-5)


@pytest.mark.cuda
def test_cpca_card_vs_cpu(cuda):
    r = np.random.RandomState(1)
    background = (r.randn(3000, 64) * 0.1).astype(np.float32)
    target = (r.randn(3000, 64) * 0.1).astype(np.float32)
    background[:, 0] += 5 * r.randn(3000)
    target[:, 0] += 5 * r.randn(3000)
    target[:, 1] += 1.5 * r.randn(3000)
    target[:, 2] += 0.7 * r.randn(3000)
    for got, want in zip(covariances(target, background, cuda),
                         covariances(target, background, "cpu")):
        assert float(torch.norm(got.cpu() - want)) <= \
            1e-12 * float(torch.norm(want))
    alphas = (0.0, 0.1, 10.0)
    c_t, c_b = (c.numpy() for c in covariances(target, background, "cpu"))
    held = 0
    for (a, comp, proj), (_, comp_c, _) in zip(
            fit_cpca(target, background, 3, alphas, device=cuda),
            fit_cpca(target, background, 3, alphas, device="cpu")):
        w = np.linalg.eigvalsh(c_t - a * c_b)[::-1]
        scale = np.abs(w).max()
        assert np.isfinite(proj).all() and proj.shape == (3000, 3)
        for i in range(3):
            gap = min(w[i - 1] - w[i] if i else np.inf, w[i] - w[i + 1])
            if gap >= 1e-3 * scale:
                assert abs(float(comp[i] @ comp_c[i])) >= 1 - 1e-4
                held += 1
    assert held >= 4


@pytest.mark.cuda
def test_recon_eval_card_vs_cpu(cuda):
    # num_hiddens 16: a latent width the lookup kernel is built for
    torch.manual_seed(0)
    cpu = VQVAEz16(num_hiddens=16, num_residual_hiddens=8, num_embeddings=16)
    card = VQVAEz16(num_hiddens=16, num_residual_hiddens=8,
                    num_embeddings=16)
    card.load_state_dict(cpu.state_dict())
    data = np.random.RandomState(2).randn(40, 2, 64, 64).astype(np.float32)
    vq.vq_lookup.launches = 0
    got = evaluate_recon_losses(card, data, n_samples=20, seed=1,
                                batch_size=8, device=cuda)
    assert vq.vq_lookup.launches == 3
    want = evaluate_recon_losses(cpu, data, n_samples=20, seed=1,
                                 batch_size=8, device="cpu")
    idx = np.random.RandomState(1).choice(np.arange(40), (20,),
                                          replace=False)
    x = torch.from_numpy(data[idx])
    same = (card.encode(x.to(cuda))[2].cpu() == cpu.encode(x)[2]) \
        .flatten(1).all(1).numpy()
    assert same.sum() >= 15
    np.testing.assert_allclose(got[same], want[same], rtol=1e-5, atol=0)
