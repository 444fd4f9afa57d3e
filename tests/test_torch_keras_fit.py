"""``Segment.fit`` from reference-trained Keras weights with the encoder
frozen, against the JAX package's on the CPU.

Both packages load one seeded ``.h5`` (``test_torch_keras_unet``'s weights,
written with h5py) into their Keras graph and fit it for one epoch of 2
steps at batch 4 of 64² with 4 validation patches, at lr 1e-6 as
``tests/test_torch_segmentation.py::test_fit_matches_jax`` holds the
torchvision-layout U-Net (its docstring says why: Adam moves every weight
by about lr whatever its gradient, and the JAX package's one-pass batch
norm variance cancels at small bottlenecks). This file has one test: its
JAX train step is the expensive compile, queued late.
"""
import os

import numpy as np
import torch

import jax

from dynamorph_tpu.seg import model as jax_model
from dynamorph_tpu.seg.model import Segment as JaxSegment
from dynamorph_tpu_torch.models.jax_import import state_dict_from_jax
from dynamorph_tpu_torch.models.unet_keras import KerasUNet, \
    encoder_layer_names
from dynamorph_tpu_torch.seg.model import Segment
from test_keras_import import write_keras_h5
from test_torch_keras_unet import keras_unet_weights
from test_torch_segmentation import FIT_LR, _adam_checked, \
    _bare_jax_segment, _max_abs
from test_torch_train import _few_threads  # noqa: F401

SIZE = 64
# pre_conv's bias feeds bn_data, a train-mode batch norm that subtracts the
# batch mean of each channel: its exact gradient is 0, so Adam moves it by
# about lr a step in the direction of rounding noise, in either package
NULL_GRADIENT = ("pre_conv.bias",)


def _pairs(seed, n):
    """n (raw (2, 1, 64, 64) float64, soft label (3, 1, 64, 64)) pairs, each
    patch at its own brightness."""
    r = np.random.RandomState(seed)
    raw = r.rand(n, 2, 1, SIZE, SIZE) * \
        r.uniform(5000, 65535, (n, 1, 1, 1, 1))
    lab = r.rand(n, 3, 1, SIZE, SIZE) ** 3
    lab /= lab.sum(1, keepdims=True)
    return [[x, y] for x, y in zip(raw, lab)]


def test_fit_from_h5_frozen_encoder_matches_jax(tmp_path, monkeypatch):
    """``freeze_encoder=True`` from an imported ``.h5``: the history within
    1e-4 relative of the JAX package's; the encoder's weights and
    ``bn_data``'s gamma bit-unchanged in both packages (the gamma is no
    parameter of the port's optimizer); every running statistic moved
    (train-mode batch norm, momentum 0.01), within 2e-3 of the largest
    magnitude of the JAX package's; every other weight moved, its change
    within 30% of the JAX package's (a tensor's norm), but for
    ``pre_conv``'s bias, whose exact gradient is 0 (``NULL_GRADIENT``),
    held to Adam's bound on its two steps; the port's two
    steps held to Adam's
    formula exactly and its first gradient to a float64 network
    (``_adam_checked``; the frozen gradients are zero); and the per-epoch
    checkpoint loads back into the Keras graph."""
    path = str(tmp_path / "unet.h5")
    write_keras_h5(path, keras_unet_weights(4))
    train, valid = _pairs(40, 8), _pairs(41, 4)

    saved = []
    monkeypatch.setattr(jax_model, "save_checkpoint",
                        lambda p, tree: saved.append(os.path.basename(p)))
    jm = _bare_jax_segment(JaxSegment, (2, SIZE, SIZE))
    jm.freeze_encoder = True
    jm.load(path)
    params0, state0 = jax.device_get((jm.params, jm.state))
    jm._lr = FIT_LR
    hj = jm.fit(train, batch_size=4, n_epochs=1, valid_patches=valid)
    params1, state1 = jax.device_get((jm.params, jm.state))

    pm = Segment(input_shape=(2, SIZE, SIZE), freeze_encoder=True,
                 model_path=str(tmp_path / "port"), device="cpu")
    pm.load(path)
    pm._lr = FIT_LR
    start = {k: v.clone() for k, v in pm.net.state_dict().items()}
    checks = []
    monkeypatch.setattr(pm, "_make_step", _adam_checked(
        pm, checks, null=NULL_GRADIENT))
    hp = pm.fit(train, batch_size=4, n_epochs=1, valid_patches=valid)
    assert len(checks) == 2 and all(
        c["worst"] <= 0 and c["moved"] > 0 for c in checks), checks
    for k in ("loss", "val_loss"):
        assert abs(hp[0][k] - hj[0][k]) <= 1e-4 * abs(hj[0][k]), k

    want = state_dict_from_jax(params1, state1, "KerasUNet")
    assert all(torch.equal(start[k], v) for k, v in state_dict_from_jax(
        params0, state0, "KerasUNet").items())
    got = pm.net.state_dict()
    encoder = tuple(n + "." for n in encoder_layer_names())
    top = _max_abs(want)
    for k, v in got.items():
        if not v.dtype.is_floating_point:
            continue
        moved = not torch.equal(v, start[k])
        if k in NULL_GRADIENT:
            assert float((v - start[k]).abs().max()) <= 3 * 2 * FIT_LR, k
        elif k.startswith(encoder) and "running" not in k:
            assert not moved and torch.equal(want[k], start[k]), k
        elif "running" in k:
            assert moved, k
            assert float((v - want[k]).abs().max()) <= 2e-3 * top, k
        else:
            d_jax = want[k].double() - start[k].double()
            d_port = v.double() - start[k].double()
            assert moved and float(d_jax.norm()) > 0, k
            assert float((d_port - d_jax).norm()) <= \
                0.3 * float(d_jax.norm()), k
    assert torch.equal(got["bn_data.weight"], torch.ones(3))
    assert np.array_equal(params1["bn_data"]["scale"], np.ones(3))
    assert not pm.net.bn_data.weight.requires_grad

    ck = Segment(input_shape=(2, SIZE, SIZE), device="cpu")
    (name,) = os.listdir(tmp_path / "port")
    assert name == saved[0] == "weights.00-%.2f" % hj[0]["val_loss"]
    ck.load(str(tmp_path / "port" / name))
    assert isinstance(ck.net, KerasUNet)
    for k, v in ck.net.state_dict().items():
        assert torch.equal(v, got[k]), k
