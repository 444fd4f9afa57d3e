"""The CUDA vq_lookup kernel against its plain PyTorch version, on a card.

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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the vq_lookup kernel runs only on "
                    "the card")
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
    rows = np.nonzero(idx != idx_ref)[0]
    z64, cb64 = z[rows].astype(np.float64), cb.astype(np.float64)
    ea, eb = cb64[idx[rows]], cb64[idx_ref[rows]]
    d_a = np.sum((z64 - ea) ** 2, axis=1)
    d_b = np.sum((z64 - eb) ** 2, axis=1)
    scale = np.sum(z64 ** 2, 1) + np.maximum(np.sum(ea ** 2, 1),
                                             np.sum(eb ** 2, 1))
    assert np.all(np.abs(d_a - d_b) <= 1e-6 * scale)


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
