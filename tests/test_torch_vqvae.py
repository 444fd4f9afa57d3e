"""The port's VQ-VAE models against the JAX models on the same weights.

Weights drawn with numpy on the JAX package's tree
(``test_torch_vae_family.numpy_weights``: ``jax.eval_shape`` of ``init``,
so no init program compiles) -> ``state_dict_from_jax`` ->
``load_state_dict(strict=True)``. z16 runs at full width (16/32/64), z32 at
a narrow one. Tolerances: z_before max-abs 1e-4 — f32 convolutions sum in
another order on XLA-CPU than on oneDNN (the JAX package's own torch parity
tests hold the same pair at MSE < 1e-5); indices equal; z_after equal
(bit for bit) where the indices are.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamorph_tpu.models import VQVAEz16 as JaxZ16, VQVAEz32 as JaxZ32
from dynamorph_tpu_torch.models import VQVAEz16, VQVAEz32, get_model_cls
from dynamorph_tpu_torch.models import common
from dynamorph_tpu_torch.models.jax_import import (load_reference_checkpoint,
                                                   state_dict_from_jax)
from test_torch_vae_family import numpy_weights
from test_torch_train import _few_threads  # noqa: F401

CONFIGS = {
    "z16": (JaxZ16, VQVAEz16, "VQ_VAE_z16",
            dict(num_hiddens=16, num_residual_hiddens=32, num_embeddings=64)),
    "z32": (JaxZ32, VQVAEz32, "VQ_VAE_z32",
            dict(num_hiddens=8, num_residual_hiddens=8, num_embeddings=32)),
}
B = 2


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    jcls, tcls, network, kw = CONFIGS[request.param]
    jmodel = jcls(vq_impl="xla", **kw)
    params, state = numpy_weights(jmodel, seed=3)
    # running statistics away from the init values, so eval-mode batch norm
    # is exercised rather than the identity
    r = np.random.RandomState(11)
    state = jax.tree_util.tree_map(
        lambda v: (v * r.uniform(0.5, 1.5, v.shape)
                   + r.uniform(-0.1, 0.1, v.shape)).astype(np.float32),
        state)
    # z-scored patches, as the encode path feeds the model
    x = np.random.RandomState(5).randn(B, 2, 128, 128).astype(np.float32)
    # codebook drawn from the latents themselves (plus noise well below
    # their spread), so the lookup spreads over many codes instead of
    # collapsing onto one
    zb = np.asarray(jmodel.encode(params, state, jnp.asarray(x))[0])
    rows = np.moveaxis(zb, 1, -1).reshape(-1, zb.shape[1])
    k = kw["num_embeddings"]
    params["vq"]["codebook"] = (
        rows[r.choice(len(rows), k, replace=False)]
        + 0.01 * rows.std(0) * r.randn(k, rows.shape[1])).astype(np.float32)
    tmodel = tcls(**kw)
    tmodel.load_state_dict(state_dict_from_jax(params, state, network),
                           strict=True)
    return jmodel, params, state, tmodel, x


def test_encode_matches_jax(pair):
    jmodel, params, state, tmodel, x = pair
    zb_j, za_j, idx_j = (np.asarray(a) for a in
                         jmodel.encode(params, state, jnp.asarray(x)))
    zb, za, idx = (a.numpy() for a in tmodel.encode(torch.from_numpy(x)))
    assert zb.shape == zb_j.shape and za.shape == za_j.shape
    assert idx.dtype == np.int32 and idx.shape == idx_j.shape
    assert np.max(np.abs(zb - zb_j)) <= 1e-4
    assert len(np.unique(idx)) >= 8                 # a real lookup
    np.testing.assert_array_equal(idx, idx_j)
    np.testing.assert_array_equal(za, za_j)


@pytest.mark.parametrize("mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("tm", [False, True], ids=["notm", "tm"])
def test_eval_apply_matches_jax(pair, mask, tm):
    jmodel, params, state, tmodel, x = pair
    r = np.random.RandomState(2)
    batch_mask = (r.rand(*x.shape) > 0.3).astype(np.float32) if mask \
        else None
    tm_mat = np.array([[2, 1], [0, 2]], np.int32) if tm else None
    dec_j, losses_j, _ = jmodel.apply(
        params, state, jnp.asarray(x), train=False,
        time_matching_mat=None if tm_mat is None else jnp.asarray(tm_mat),
        batch_mask=None if batch_mask is None else jnp.asarray(batch_mask))
    dec, losses = tmodel.apply(
        torch.from_numpy(x), train=False,
        time_matching_mat=None if tm_mat is None else torch.from_numpy(tm_mat),
        batch_mask=None if batch_mask is None
        else torch.from_numpy(batch_mask))
    assert np.max(np.abs(dec.numpy() - np.asarray(dec_j))) <= 1e-4
    assert set(losses) == set(losses_j)
    for k in losses:
        assert abs(float(losses[k]) - float(losses_j[k])) <= 1e-4, k


def test_decode_matches_jax(pair):
    jmodel, params, state, tmodel, x = pair
    zb, _, _ = tmodel.encode(torch.from_numpy(x))
    dec_j = jmodel.decode(params, state, jnp.asarray(zb.numpy()))
    dec = tmodel.decode(zb)
    assert np.max(np.abs(dec.numpy() - np.asarray(dec_j))) <= 1e-4


def test_train_flag_not_module_mode_decides(pair):
    """model.train() changes no result of encode, decode or eval apply: the
    ``train`` argument decides how batch norm runs. apply(train=True)
    returns losses with autograd live and leaves the module's mode as it
    found it."""
    *_, tmodel, x = pair
    xt = torch.from_numpy(x)
    ref = tmodel.encode(xt)
    ref_dec = tmodel.decode(ref[0])
    ref_loss = tmodel.apply(xt)[1]["total_loss"]
    tmodel.train()
    try:
        for a, b in zip(tmodel.encode(xt), ref):
            assert torch.equal(a, b)
        assert torch.equal(tmodel.decode(ref[0]), ref_dec)
        assert torch.equal(tmodel.apply(xt)[1]["total_loss"], ref_loss)
        assert tmodel.training
    finally:
        tmodel.eval()
    model = copy.deepcopy(tmodel)          # train mode updates the buffers
    _, losses = model.apply(xt, train=True)
    assert losses["total_loss"].requires_grad
    assert not model.training


def test_fused_stem_equals_unfused(rng):
    model = VQVAEz16(num_hiddens=16)
    x = torch.from_numpy(rng.rand(2, 2, 64, 48).astype(np.float32))
    conv0, conv1 = model.enc[0], model.enc[1]
    with torch.no_grad():
        fused = common.fused_preconv_stride_conv(conv0, conv1, x)
        plain = conv1(conv0(x))
    assert fused.shape == plain.shape
    assert torch.max(torch.abs(fused - plain)) <= 1e-5


def test_reference_checkpoint_roundtrip(tmp_path):
    """A model.pt of reference names loads strictly into a fresh model and
    reproduces the latents."""
    torch.manual_seed(0)
    src = VQVAEz16(num_hiddens=8, num_residual_hiddens=8, num_embeddings=16)
    path = tmp_path / "model.pt"
    torch.save(src.state_dict(), path)
    sd = load_reference_checkpoint(str(path))
    assert "vq.w.weight" in sd and "enc.12.layers.1.5.running_var" in sd
    dst = VQVAEz16(num_hiddens=8, num_residual_hiddens=8, num_embeddings=16)
    dst.load_state_dict(sd, strict=True)
    x = torch.rand(1, 2, 64, 64)
    for a, b in zip(src.encode(x), dst.encode(x)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["VAE", "IWAE", "AAE"])
def test_unported_networks_name_their_slice(name):
    """The networks that once named the slice that would port them
    (Slice E1) are now registered under the JAX package's names; an
    unknown name still raises and lists what there is."""
    from dynamorph_tpu.models.registry import get_model_cls as jax_cls

    assert get_model_cls(name).__name__ == jax_cls(name).__name__
    with pytest.raises(ValueError, match="available"):
        get_model_cls(name + "_z8")
