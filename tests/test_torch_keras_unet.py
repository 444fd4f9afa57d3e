"""The port's Keras-architecture U-Net (``models/unet_keras.py``) and its
``.h5`` import (``seg/keras_import.py``, read by ``io/hdf5.py``) against the
JAX package on the CPU, on the same seeded Keras weights.

The weights are drawn with numpy in the Keras layout for every layer of the
reference graph (He-scaled kernels, batch norm off the identity) and
written with h5py in ``save_weights``'s layout
(``tests/test_keras_import.py::write_keras_h5``). The JAX side reads them
with its own importer (h5py) and runs its jitted ``KerasUNet``; the port
reads them with its own HDF5 reader. The float64 torch oracle of the Keras
graph (``oracle_logits``) is the third party.

Tolerances: probabilities within 1e-5 of the oracle's; the import itself
is exact. The forward passes against the JAX package's compiled graphs
(logits within 1e-5 of max |logit|) are in
``tests/test_torch_keras_forward.py``.
"""
import numpy as np
import pytest
import torch
from torch import nn

import jax

from dynamorph_tpu.models.unet_keras import \
    encoder_layer_names as jax_encoder_layer_names
from dynamorph_tpu.seg import keras_import as jax_ki
from dynamorph_tpu_torch.models.jax_import import state_dict_from_jax
from dynamorph_tpu_torch.models.unet_keras import (KerasUNet,
                                                   MultiSliceKerasUNet,
                                                   encoder_layer_names)
from dynamorph_tpu_torch.seg import keras_import
from dynamorph_tpu_torch.seg.model import Segment, SegmentWithMultipleSlice
from test_keras_import import oracle_logits, write_keras_h5
from test_torch_segmentation import _bare_jax_segment
from test_torch_train import _few_threads  # noqa: F401

LOGIT_RTOL = 1e-5
PROB_ATOL = 1e-5
SIZE = 64
MS_SIZE = 32
MS_FEAT = 8
MS_SLICES = 3


def keras_unet_weights(seed=0, n_channels=2, n_classes=3, unet_feat=None,
                       n_slices=None):
    """{layer: {"<weight>:0": array}} for every layer of the reference
    graph (the 2.5-D one with ``unet_feat``), in Keras's layout: kernels
    (kh, kw, in, out) He-scaled so activations stay O(1), biases N(0, 0.1),
    gamma U(0.5, 1.5) (none for ``bn_data``), beta and moving mean
    N(0, 0.2), moving variance U(0.5, 1.5). ``final_conv``'s kernel is
    scaled by 1/200 (1/20 before the 2.5-D heads) so the logits are O(1)
    to O(10), as a trained model's are (He scaling alone leaves them near
    1,000, where every probability is 0 or 1)."""
    with torch.device("meta"):
        net = KerasUNet(n_channels, n_classes) if unet_feat is None else \
            MultiSliceKerasUNet(n_channels, n_slices, n_classes, unet_feat)
    r = np.random.RandomState(seed)
    W = {}
    for name, m in net.named_children():
        if isinstance(m, nn.Conv2d):
            o, i, kh, kw = m.weight.shape
            lw = {"kernel:0": r.randn(kh, kw, i, o) * np.sqrt(
                2.0 / (kh * kw * i))}
            if name == "final_conv":
                lw["kernel:0"] /= 200 if unet_feat is None else 20
            if m.bias is not None:
                lw["bias:0"] = r.randn(o) * 0.1
        else:
            n = m.num_features
            lw = {} if name == "bn_data" else {"gamma:0": r.rand(n) + 0.5}
            lw.update({"beta:0": r.randn(n) * 0.2,
                       "moving_mean:0": r.randn(n) * 0.2,
                       "moving_variance:0": r.rand(n) + 0.5})
        W[name] = {k: v.astype(np.float32) for k, v in lw.items()}
    return W


def jax_import(path):
    """The JAX package's import of ``path`` as numpy (params, state)."""
    return jax.device_get(jax_ki.import_keras_unet(path))


@pytest.fixture(scope="module")
def unet(tmp_path_factory):
    """(weights, .h5 path, input, the float64 oracle's logits)."""
    W = keras_unet_weights(0)
    path = str(tmp_path_factory.mktemp("keras") / "unet.h5")
    write_keras_h5(path, W)
    x = np.random.RandomState(1).rand(2, 2, SIZE, SIZE).astype(np.float32)
    return W, path, x, oracle_logits(W, x)


def test_import_equals_jax_bridge(unet):
    """The port's import is the JAX import through ``state_dict_from_jax``
    bit for bit, under the Keras layer names, and the encoder's names are
    the JAX package's."""
    _, path, _, _ = unet
    sd = keras_import.import_keras_unet(path)
    bridged = state_dict_from_jax(*jax_import(path), "KerasUNet")
    assert sorted(sd) == sorted(bridged) == sorted(KerasUNet().state_dict())
    for k, v in sd.items():
        assert torch.equal(v, bridged[k]), k
    for k in ("conv0.weight", "stage1_unit1_bn1.running_mean",
              "stage4_unit1_sc.weight", "decoder_stage0a_conv.weight",
              "decoder_stage4b_bn.running_var", "final_conv.bias"):
        assert k in sd
    assert torch.equal(sd["bn_data.weight"], torch.ones(3))
    assert encoder_layer_names() == jax_encoder_layer_names()


@pytest.mark.parametrize("layout", ["save_weights", "model_weights", "npz",
                                    "chip_smoke_writer"])
def test_layouts_import_alike(unet, tmp_path, layout):
    """``save_weights``'s layout (a nested model group), ``model.save``'s
    (under ``model_weights``), the exporter's ``.npz`` and the file
    chip_smoke.py writes without h5py import to the same state_dict, and
    the JAX importer reads each alike."""
    import chip_smoke

    W, path, _, _ = unet
    want = keras_import.import_keras_unet(path)
    if layout == "npz":
        other = str(tmp_path / "w.npz")
        np.savez(other, **{f"{k}/{w}": v for k, lw in W.items()
                           for w, v in lw.items()})
    else:
        other = str(tmp_path / "w.h5")
        if layout == "chip_smoke_writer":
            chip_smoke.write_h5(other, *chip_smoke.keras_h5_layout(
                W, nested="model_2"))
        else:
            write_keras_h5(other, W, nested_name="model_3",
                           wrap_model_weights=layout == "model_weights")
    got = keras_import.import_keras_unet(other)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    jp, js = jax_import(other)
    for k, v in state_dict_from_jax(jp, js, "KerasUNet").items():
        assert torch.equal(v, want[k]), k


def _refusal(case, W, tmp_path):
    """(the port's call, the JAX package's call) that must raise alike."""
    path = str(tmp_path / f"{case}.h5")
    if case == "missing_layer":
        write_keras_h5(path, {k: v for k, v in W.items()
                              if k != "stage3_unit2_conv1"})
        return (lambda: keras_import.import_keras_unet(path),
                lambda: jax_ki.import_keras_unet(path))
    if case == "missing_weight":
        write_keras_h5(path, dict(W, bn0={k: v for k, v in W["bn0"].items()
                                          if k != "moving_variance:0"}))
        return (lambda: keras_import.import_keras_unet(path),
                lambda: jax_ki.import_keras_unet(path))
    if case == "extra_layer":
        write_keras_h5(path, dict(W, extra_dense={
            "kernel:0": np.zeros((4, 4), np.float32)}))
        return (lambda: keras_import.import_keras_unet(path),
                lambda: jax_ki.import_keras_unet(path))
    if case == "shape_mismatch":
        write_keras_h5(path, W)
        return (lambda: keras_import.import_keras_unet(path, n_classes=4),
                lambda: jax_ki.import_keras_unet(path, n_classes=4))
    if case == "multislice_into_segment":
        write_keras_h5(path, keras_unet_weights(
            1, unet_feat=MS_FEAT, n_slices=MS_SLICES))
        return (lambda: Segment(input_shape=(2, SIZE, SIZE),
                                device="cpu").load(path),
                lambda: jax_ki.import_keras_unet(path))
    if case == "2d_into_multislice":
        write_keras_h5(path, W)
        return (lambda: SegmentWithMultipleSlice(
                    unet_feat=MS_FEAT, input_shape=(2, MS_SLICES, SIZE, SIZE),
                    device="cpu").load(path),
                lambda: jax_ki.multislice_dims_from_file(path))
    if case == "feat_not_dividing":
        ms = keras_unet_weights(1, unet_feat=MS_FEAT, n_slices=MS_SLICES)
        ms["post_conv"]["kernel:0"] = np.zeros((1, 1, 20, MS_FEAT),
                                               np.float32)
        write_keras_h5(path, ms)
        return (lambda: keras_import.multislice_dims_from_file(path),
                lambda: jax_ki.multislice_dims_from_file(path))
    assert case == "dims_requested"
    write_keras_h5(path, keras_unet_weights(
        1, unet_feat=MS_FEAT, n_slices=MS_SLICES))
    return (lambda: keras_import.import_keras_unet_multislice(
                path, n_slices=MS_SLICES + 1),
            lambda: jax_ki.import_keras_unet_multislice(
                path, n_slices=MS_SLICES + 1))


@pytest.mark.parametrize("case", [
    "missing_layer", "missing_weight", "extra_layer", "shape_mismatch",
    "multislice_into_segment", "2d_into_multislice", "feat_not_dividing",
    "dims_requested"])
def test_refusals_match_jax(unet, tmp_path, case):
    """Every refusal of the import raises ValueError with the JAX
    package's message: a missing layer or weight, an extra weighted layer,
    a shape mismatch, a 2.5-D file given to ``Segment`` (with the hint to
    ``SegmentWithMultipleSlice``), a 2-D file given to
    ``SegmentWithMultipleSlice``, a merge width that is no multiple of the
    feature width, and dimensions the file does not encode."""
    W = unet[0]
    port, jax_call = _refusal(case, W, tmp_path)
    with pytest.raises(ValueError) as got:
        port()
    with pytest.raises(ValueError) as want:
        jax_call()
    assert str(got.value) == str(want.value)


def test_multislice_dims_mismatch_matches_jax(tmp_path):
    """``SegmentWithMultipleSlice.load`` of a 2.5-D file of other slices
    raises the JAX package's message (the dims read once from the file)."""
    from dynamorph_tpu.seg.model import SegmentWithMultipleSlice as JaxMS

    path = str(tmp_path / "ms.h5")
    write_keras_h5(path, keras_unet_weights(
        1, unet_feat=MS_FEAT, n_slices=MS_SLICES))
    shape = (2, MS_SLICES + 1, MS_SIZE, MS_SIZE)
    with pytest.raises(ValueError) as got:
        SegmentWithMultipleSlice(input_shape=shape, device="cpu").load(path)
    js = _bare_jax_segment(JaxMS, shape, unet_feat=32)
    with pytest.raises(ValueError) as want:
        js.load(path)
    assert str(got.value) == str(want.value)


def test_segment_load_h5_and_model_pt_roundtrip(unet, tmp_path):
    """``Segment.load`` of the ``.h5`` switches to the Keras graph and
    predicts the float64 oracle's probabilities (within 1e-5); its
    ``save`` then loads into a fresh
    ``Segment`` (recognised by its ``bn_data.*`` names) to the same
    probabilities, and a torchvision-layout ``model.pt`` switches it
    back."""
    _, path, x, golden = unet
    pm = Segment(input_shape=(2, SIZE, SIZE), device="cpu")
    torchvision_layout = pm.net.state_dict()
    pm.load(path)
    assert isinstance(pm.net, KerasUNet)
    e = np.exp(golden - golden.max(1, keepdims=True))
    want = (e / e.sum(1, keepdims=True))[:, :, None]
    got = pm.predict(x)
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)
    pm.save(str(tmp_path / "keras_model"))
    fresh = Segment(input_shape=(2, SIZE, SIZE), seed=3, device="cpu")
    fresh.load(str(tmp_path / "keras_model"))
    assert isinstance(fresh.net, KerasUNet)
    np.testing.assert_array_equal(fresh.predict(x), got)
    torch.save(torchvision_layout, tmp_path / "unet.pt")
    fresh.load(str(tmp_path / "unet.pt"))
    assert not isinstance(fresh.net, KerasUNet)


def test_multislice_state_dict_names(tmp_path):
    """The 2.5-D model's heads sit beside the body's Keras names, and
    ``load_state_dict(strict=True)`` takes the JAX 2.5-D import bridged."""
    path = str(tmp_path / "ms.h5")
    write_keras_h5(path, keras_unet_weights(
        2, unet_feat=MS_FEAT, n_slices=MS_SLICES))
    sd = state_dict_from_jax(*jax.device_get(
        jax_ki.import_keras_unet_multislice(path)), "KerasUNet")
    net = MultiSliceKerasUNet(2, MS_SLICES, 3, MS_FEAT)
    net.load_state_dict(sd, strict=True)
    assert sd["post_conv.weight"].shape == (MS_FEAT, MS_SLICES * MS_FEAT, 1,
                                            1)
    assert sd["pred_head.bias"].shape == (3,)
