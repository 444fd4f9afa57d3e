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


INDICES_SHAPES = [(64, 16, 64), (300, 16, 512), (512, 64, 512)]


@pytest.mark.parametrize("tied", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("n,d,k", INDICES_SHAPES)
def test_indices_plain_matches_jax_xla_and_pallas(rng, n, d, k, tied):
    """vq_indices' plain version against JAX vq_indices: the XLA path at
    "high" (the model's default) and kernel 2 (_vq_pallas_idx) in interpret
    mode at "highest". Indices equal."""
    if tied:
        z, cb = _tied(rng, n, d, k)
    else:
        z = rng.randn(n, d).astype(np.float32)
        cb = rng.randn(k, d).astype(np.float32)
    idx = tvq.vq_indices(torch.from_numpy(z), torch.from_numpy(cb),
                         precision="high").numpy()
    idx_x = jvq.vq_indices(jnp.asarray(z), jnp.asarray(cb), impl="xla",
                           precision="high")
    idx_p = jvq.vq_indices(jnp.asarray(z), jnp.asarray(cb), impl="pallas",
                           precision="highest")
    assert idx.dtype == np.int32 and idx.shape == (n,)
    np.testing.assert_array_equal(idx, np.asarray(idx_x))
    np.testing.assert_array_equal(idx, np.asarray(idx_p))
    # the search of vq_lookup, without the rows
    np.testing.assert_array_equal(idx, _port(z, cb)[1])
    if tied:
        assert set(np.unique(idx[::3])) == {3}
        assert set(np.unique(idx[2::3])) == {1}


def test_indices_keep_leading_shape_and_refuse_unknown_precision(rng):
    z = torch.from_numpy(rng.randn(2, 4, 4, 16).astype(np.float32))
    cb = torch.from_numpy(rng.randn(64, 16).astype(np.float32))
    for precision in tvq.PRECISIONS:
        idx = tvq.vq_indices(z, cb, precision=precision)
        assert idx.shape == (2, 4, 4)
        np.testing.assert_array_equal(idx.numpy(), _port(z.numpy(),
                                                         cb.numpy())[1])
    with pytest.raises(ValueError, match="precision"):
        tvq.vq_indices(z, cb, precision="bf16")


@pytest.mark.parametrize("n,k,d", [(300, 64, 16), (2048, 512, 64)])
def test_gather_codes_matches_jax(rng, n, k, d):
    """Forward equal to JAX gather_codes; the codebook gradient equal to
    JAX's custom VJP and to index_select's autograd within rtol 1e-5,
    atol 1e-6 (fp32 summation order, as tests/test_vq.py allows)."""
    import jax

    cb = rng.randn(k, d).astype(np.float32)
    idx = rng.randint(0, k, size=(n,)).astype(np.int32)
    idx[: n // 4] = 7                       # one code used many times
    ct = rng.randn(n, d).astype(np.float32)

    cbt = torch.from_numpy(cb).requires_grad_(True)
    out = tvq.gather_codes(cbt, torch.from_numpy(idx))
    out_j, vjp = jax.vjp(lambda c: jvq.gather_codes(c, jnp.asarray(idx)),
                         jnp.asarray(cb))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    (out * torch.from_numpy(ct)).sum().backward()
    (grad_j,) = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(cbt.grad.numpy(), np.asarray(grad_j),
                               rtol=1e-5, atol=1e-6)

    cb_ref = torch.from_numpy(cb).requires_grad_(True)
    ref = torch.index_select(cb_ref, 0, torch.from_numpy(idx).long())
    (ref * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(cbt.grad.numpy(), cb_ref.grad.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_gather_codes_keeps_leading_shape(rng):
    cb = torch.from_numpy(rng.randn(8, 16).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 8, (2, 3, 3)).astype(np.int32))
    out = tvq.gather_codes(cb, idx)
    assert out.shape == (2, 3, 3, 16)
    assert torch.equal(out, cb[idx.long()])
