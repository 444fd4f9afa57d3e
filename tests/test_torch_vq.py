"""The port's codebook lookup against the JAX package: the plain version
(CPU) vs ``vq_lookup(impl="xla")`` and the Pallas kernel ``_vq_pallas`` in
interpret mode, forced ties included. The CUDA kernel is held against the
plain version in test_torch_vq_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dynamorph_tpu.ops import vq as jvq
from dynamorph_tpu_torch.ops import vq as tvq

SHAPES = [(64, 16, 64), (300, 16, 512), (1025, 64, 128), (512, 64, 512)]


def _tied(rng, n, d, k):
    """Codebook with duplicated rows and latents sitting exactly on them:
    every such row ties between a code and its later copies, and the lowest
    index must win."""
    cb = rng.randn(k, d).astype(np.float32)
    cb[k // 2] = cb[3]
    cb[k - 1] = cb[3]
    cb[k - 2] = cb[1]
    z = np.empty((n, d), np.float32)
    z[::3] = cb[3]
    z[1::3] = cb[k // 2]
    z[2::3] = cb[1] + 1e-3
    return z, cb


def _port(z, cb):
    q, idx = tvq.vq_lookup(torch.from_numpy(z), torch.from_numpy(cb))
    return q.numpy(), idx.numpy()


@pytest.mark.parametrize("tied", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("n,d,k", SHAPES)
def test_plain_matches_jax_xla_and_pallas(rng, n, d, k, tied):
    if tied:
        z, cb = _tied(rng, n, d, k)
    else:
        z = rng.randn(n, d).astype(np.float32)
        cb = rng.randn(k, d).astype(np.float32)
    q, idx = _port(z, cb)
    q_x, idx_x = jvq.vq_lookup(jnp.asarray(z), jnp.asarray(cb), impl="xla")
    q_p, idx_p = jvq._vq_pallas(jnp.asarray(z), jnp.asarray(cb))
    assert idx.dtype == np.int32
    np.testing.assert_array_equal(idx, np.asarray(idx_x))
    np.testing.assert_array_equal(idx, np.asarray(idx_p))
    np.testing.assert_array_equal(q, cb[idx])          # exact gather
    np.testing.assert_array_equal(q, np.asarray(q_p))
    if tied:
        assert set(np.unique(idx[::3])) == {3}
        assert set(np.unique(idx[1::3])) == {3}
        assert set(np.unique(idx[2::3])) == {1}


def test_leading_shape_preserved(rng):
    z = rng.randn(2, 4, 4, 16).astype(np.float32)
    cb = rng.randn(64, 16).astype(np.float32)
    q, idx = _port(z, cb)
    q_x, idx_x = jvq.vq_lookup(jnp.asarray(z), jnp.asarray(cb), impl="xla")
    assert q.shape == z.shape and idx.shape == (2, 4, 4)
    np.testing.assert_array_equal(idx, np.asarray(idx_x))


@pytest.mark.parametrize("k", [8, 64])
def test_counts_and_perplexity_match_jax(rng, k):
    idx = rng.randint(0, k, size=(4, 16, 16)).astype(np.int32)
    idx[0] = 0                                  # uneven usage
    counts = tvq.vq_codebook_counts(torch.from_numpy(idx), k)
    counts_j = jvq.vq_codebook_counts(jnp.asarray(idx), k)
    assert counts.dtype == torch.float32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    np.testing.assert_allclose(
        float(tvq.perplexity_from_counts(counts)),
        float(jvq.perplexity_from_counts(counts_j)), rtol=1e-6)
