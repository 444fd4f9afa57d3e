"""The port's Keras-architecture U-Net against the JAX package's compiled
graphs on the CPU: the 2-D logits (and the float64 oracle's), the 2.5-D
model loaded from its ``.h5``, and ``verify_against_golden``. The weights
and files are ``test_torch_keras_unet``'s. At most 3 tests: the JAX
programs are the cost, queued late.

Tolerance: logits within 1e-5 of max |logit| (fp32 summation order, XLA
CPU against oneDNN, through about 40 convolutions).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamorph_tpu.models.unet_keras import KerasUNet as JaxKerasUNet
from dynamorph_tpu.seg import keras_import as jax_ki
from dynamorph_tpu_torch.models.jax_import import state_dict_from_jax
from dynamorph_tpu_torch.models.unet_keras import (KerasUNet,
                                                   MultiSliceKerasUNet)
from dynamorph_tpu_torch.seg import keras_import
from dynamorph_tpu_torch.seg.model import SegmentWithMultipleSlice
from test_keras_import import oracle_logits, write_keras_h5
from test_torch_keras_unet import (MS_FEAT, MS_SIZE, MS_SLICES, SIZE,
                                   jax_import, keras_unet_weights)
from test_torch_segmentation import _bare_jax_segment
from test_torch_train import _few_threads  # noqa: F401

LOGIT_RTOL = 1e-5


@pytest.fixture(scope="module")
def unet(tmp_path_factory):
    """(weights, .h5 path, input, oracle logits, JAX logits)."""
    W = keras_unet_weights(0)
    path = str(tmp_path_factory.mktemp("keras") / "unet.h5")
    write_keras_h5(path, W)
    x = np.random.RandomState(1).rand(2, 2, SIZE, SIZE).astype(np.float32)
    params, state = jax_import(path)
    logits, _ = jax.jit(lambda p, s, x: JaxKerasUNet().apply(p, s, x))(
        params, state, jnp.asarray(x))
    return W, path, x, oracle_logits(W, x), np.asarray(logits)


def test_logits_match_jax_and_oracle(unet):
    """The imported port net's logits at 2 x 2 x 64² within 1e-5 of max
    |logit| of the JAX ``KerasUNet``'s and of the float64 oracle's."""
    _, path, x, golden, lj = unet
    net = KerasUNet()
    net.load_state_dict(keras_import.import_keras_unet(path), strict=True)
    with torch.no_grad():
        lt = net.apply(torch.from_numpy(x)).numpy()
    top = np.abs(golden).max()
    assert lt.shape == golden.shape == (2, 3, SIZE, SIZE)
    assert np.abs(lt - lj).max() <= LOGIT_RTOL * top
    assert np.abs(lt - golden).max() <= LOGIT_RTOL * top
    assert top > 1.0


@pytest.fixture(scope="module")
def multislice(tmp_path_factory):
    """A 2.5-D ``.h5`` and the JAX ``SegmentWithMultipleSlice`` loaded
    from it."""
    from dynamorph_tpu.seg.model import SegmentWithMultipleSlice as JaxMS

    path = str(tmp_path_factory.mktemp("ms") / "ms.h5")
    write_keras_h5(path, keras_unet_weights(
        2, unet_feat=MS_FEAT, n_slices=MS_SLICES))
    js = _bare_jax_segment(JaxMS, (2, MS_SLICES, MS_SIZE, MS_SIZE),
                           unet_feat=32)
    js.load(path)
    return path, js


def test_multislice_load_matches_jax(multislice):
    """``SegmentWithMultipleSlice.load`` of a 2.5-D ``.h5``: the feature
    width comes from the file, the dims probe equals the JAX package's, the
    import is the JAX one bridged, the logits of 2 samples are within 1e-5
    of max |logit| of the JAX model's, and ``predict`` is their
    softmax."""
    path, js = multislice
    ps = SegmentWithMultipleSlice(input_shape=(2, MS_SLICES, MS_SIZE,
                                               MS_SIZE), device="cpu")
    ps.load(path)
    assert ps.unet_feat == js.unet_feat == MS_FEAT
    assert isinstance(ps.net, MultiSliceKerasUNet)
    assert keras_import.multislice_dims_from_file(path) == \
        jax_ki.multislice_dims_from_file(path) == (2, MS_SLICES, MS_FEAT, 3)
    assert keras_import.is_multislice_weight_file(path)
    sd = keras_import.import_keras_unet_multislice(path)
    bridged = state_dict_from_jax(*jax.device_get(
        jax_ki.import_keras_unet_multislice(path)), "KerasUNet")
    assert sorted(sd) == sorted(bridged)
    assert all(torch.equal(sd[k], bridged[k]) for k in sd)
    x = np.random.RandomState(3).rand(2, 2, MS_SLICES, MS_SIZE, MS_SIZE) \
        .astype(np.float32)
    want, _ = jax.jit(lambda p, s, x: js._apply_logits(p, s, x, False))(
        js.params, js.state, jnp.asarray(x))
    want = np.asarray(want)
    with torch.no_grad():
        got = ps.net.apply(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 3, MS_SIZE, MS_SIZE)
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= LOGIT_RTOL * top and top > 1.0
    probs = ps.predict(x)
    np.testing.assert_allclose(probs[:, :, 0], torch.softmax(
        torch.from_numpy(got), 1).numpy(), atol=1e-6, rtol=0)


def test_verify_against_golden(unet, tmp_path):
    """``verify_against_golden`` passes the imported model on the oracle's
    goldens (exporter ``.npz`` layout) and raises on a shifted bias, as
    the JAX package's does (its deviation within 1e-5 of the port's)."""
    _, path, x, golden, _ = unet
    npz = str(tmp_path / "golden.npz")
    np.savez(npz, golden_input=x, golden_logits=golden)
    net = KerasUNet()
    net.load_state_dict(keras_import.import_keras_unet(path), strict=True)
    dev = keras_import.verify_against_golden(net, npz)
    params, state = jax_import(path)
    dev_jax = jax_ki.verify_against_golden(JaxKerasUNet(), params, state,
                                           npz)
    assert dev < 2e-3 and abs(dev - dev_jax) <= LOGIT_RTOL * np.abs(
        golden).max()
    with torch.no_grad():
        net.final_conv.bias += 0.5
    with pytest.raises(AssertionError, match="deviates"):
        keras_import.verify_against_golden(net, npz)
    np.savez(str(tmp_path / "bare.npz"), x=x)
    with pytest.raises(ValueError, match="no golden activations"):
        keras_import.verify_against_golden(net, str(tmp_path / "bare.npz"))
