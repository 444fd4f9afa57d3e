"""The CUDA kernels (vq_lookup, vq_indices) against their plain PyTorch
versions, and gather_codes on the card against the CPU.

This file imports neither jax nor the JAX package, so it also runs on a GPU
host without them: ``python -m pytest --noconftest tests/test_torch_vq_cuda.py``.
Without a card every test skips.
"""
import numpy as np
import pytest
import torch

from dynamorph_tpu_torch.ops import vq

SHAPES = [(64, 16, 64), (300, 16, 512), (1025, 64, 128), (512, 64, 512),
          (131072, 16, 64)]
TRAIN_SHAPE = (786432, 64, 512)     # z32 training: 768 x 32 x 32 latents


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the vq kernels run only on the "
                    "card")
    return torch.device("cuda")


def _inputs(n, d, k, tied):
    r = np.random.RandomState(n + d + k)
    cb = r.randn(k, d).astype(np.float32)
    if not tied:
        return r.randn(n, d).astype(np.float32), cb
    # duplicated codebook rows and latents exactly on them: lowest index wins
    cb[k // 2] = cb[3]
    cb[k - 1] = cb[3]
    z = np.empty((n, d), np.float32)
    z[::2] = cb[3]
    z[1::2] = cb[k // 2]
    return z, cb


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("n,d,k", SHAPES)
def test_kernel_matches_plain(cuda, n, d, k, tied):
    """idx equal to the plain version's apart from float64-verified
    near-ties; q bit-equal to codebook[idx]. A near-tie: the two distances
    differ by less than 1e-6 of |z|^2 + max |E|^2, the size of the terms the
    fp32 formula |E|^2 - 2 z.E cancels."""
    z, cb = _inputs(n, d, k, tied)
    zt, cbt = torch.from_numpy(z).to(cuda), torch.from_numpy(cb).to(cuda)
    before = vq.vq_lookup.launches
    q, idx = vq.vq_lookup(zt, cbt)
    torch.cuda.synchronize()
    assert vq.vq_lookup.launches == before + 1
    assert idx.dtype == torch.int32 and q.shape == zt.shape
    _, idx_ref = vq.vq_lookup_reference(zt, cbt)
    q, idx, idx_ref = (t.cpu().numpy() for t in (q, idx, idx_ref))
    np.testing.assert_array_equal(q, cb[idx])
    if tied:
        assert set(np.unique(idx)) == {3}
    _assert_near_ties(z, cb, idx, idx_ref)


def _assert_near_ties(z, cb, idx, idx_ref):
    rows = np.nonzero(idx != idx_ref)[0]
    z64, cb64 = z[rows].astype(np.float64), cb.astype(np.float64)
    ea, eb = cb64[idx[rows]], cb64[idx_ref[rows]]
    d_a = np.sum((z64 - ea) ** 2, axis=1)
    d_b = np.sum((z64 - eb) ** 2, axis=1)
    scale = np.sum(z64 ** 2, 1) + np.maximum(np.sum(ea ** 2, 1),
                                             np.sum(eb ** 2, 1))
    assert np.all(np.abs(d_a - d_b) <= 1e-6 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("n,d,k", SHAPES + [TRAIN_SHAPE])
def test_indices_kernel_matches_plain(cuda, n, d, k, tied):
    """vq_indices: idx equal to the plain version's apart from
    float64-verified near-ties (the criterion above), and equal to what the
    lookup kernel picks (one distance loop serves both)."""
    z, cb = _inputs(n, d, k, tied)
    zt, cbt = torch.from_numpy(z).to(cuda), torch.from_numpy(cb).to(cuda)
    before = vq.vq_indices.launches
    idx = vq.vq_indices(zt, cbt, precision="high")
    torch.cuda.synchronize()
    assert vq.vq_indices.launches == before + 1
    assert idx.dtype == torch.int32 and idx.shape == (n,)
    _, idx_lookup = vq._vq_lookup_cuda(zt, cbt)
    assert torch.equal(idx, idx_lookup)
    idx_ref = vq.vq_indices_reference(zt, cbt)
    idx, idx_ref = idx.cpu().numpy(), idx_ref.cpu().numpy()
    if tied:
        assert set(np.unique(idx)) == {3}
    _assert_near_ties(z, cb, idx, idx_ref)


@pytest.mark.cuda
def test_indices_keep_leading_shape(cuda):
    z = torch.randn(2, 32, 32, 64, device=cuda)
    cb = torch.randn(512, 64, device=cuda)
    idx = vq.vq_indices(z, cb)
    _, idx_lookup = vq.vq_lookup(z, cb)
    assert idx.shape == (2, 32, 32) and torch.equal(idx, idx_lookup)


@pytest.mark.cuda
def test_kernel_keeps_leading_shape(cuda):
    z = torch.randn(2, 16, 16, 16, device=cuda)
    cb = torch.randn(64, 16, device=cuda)
    q, idx = vq.vq_lookup(z, cb)
    assert q.shape == z.shape and idx.shape == (2, 16, 16)
    assert torch.equal(q, cb[idx.long()])


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    z = torch.randn(8, 16, device=cuda)
    cb = torch.randn(4, 16, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        vq._vq_lookup_cuda(z.double(), cb)
    with pytest.raises(ValueError, match="contiguous"):
        vq._vq_lookup_cuda(torch.randn(16, 8, device=cuda).T, cb)
    with pytest.raises(ValueError, match="latent width"):
        vq._vq_lookup_cuda(torch.randn(8, 12, device=cuda),
                           torch.randn(4, 12, device=cuda))
    with pytest.raises(ValueError, match="do not match"):
        vq._vq_lookup_cuda(z, torch.randn(4, 32, device=cuda))


@pytest.mark.cuda
def test_indices_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    z = torch.randn(8, 16, device=cuda)
    cb = torch.randn(4, 16, device=cuda)
    before = vq.vq_indices.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        vq._vq_indices_cuda(z.cpu(), cb)
    with pytest.raises(TypeError, match="float32"):
        vq._vq_indices_cuda(z.double(), cb)
    with pytest.raises(ValueError, match="contiguous"):
        vq._vq_indices_cuda(torch.randn(16, 8, device=cuda).T, cb)
    with pytest.raises(ValueError, match="latent width"):
        vq._vq_indices_cuda(torch.randn(8, 12, device=cuda),
                            torch.randn(4, 12, device=cuda))
    with pytest.raises(ValueError, match="do not match"):
        vq._vq_indices_cuda(z, torch.randn(4, 32, device=cuda))
    with pytest.raises(ValueError, match="precision"):
        vq.vq_indices(z, cb, precision="tf32")
    assert vq.vq_indices.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d", [(300, 64, 16), (65536, 512, 64)])
def test_gather_codes_on_card_matches_cpu(cuda, n, k, d):
    """Forward bit-equal; the codebook gradient (a fp32 one-hot product on
    the card, without TF32) within rtol 1e-4, atol 1e-4 of the CPU's: a row
    sums up to 16,384 products (|sum| up to about 130) in another order.
    Two runs on the card agree bit for bit."""
    r = np.random.RandomState(n)
    cb = torch.from_numpy(r.randn(k, d).astype(np.float32))
    idx = torch.from_numpy(r.randint(0, k, (n,)).astype(np.int32))
    idx[: n // 4] = 5
    ct = torch.from_numpy(r.randn(n, d).astype(np.float32))

    def grad(device):
        c = cb.to(device, copy=True).requires_grad_(True)
        out = vq.gather_codes(c, idx.to(device))
        (out * ct.to(device)).sum().backward()
        return out.detach().cpu(), c.grad.cpu()

    out_gpu, g_gpu = grad(cuda)
    out_cpu, g_cpu = grad("cpu")
    assert torch.equal(out_gpu, out_cpu)
    np.testing.assert_allclose(g_gpu.numpy(), g_cpu.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(grad(cuda)[1], g_gpu)
