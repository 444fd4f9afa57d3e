"""The ImageNet baseline networks against the JAX package on the CPU:
InceptionResNetV2 (``models/inception_resnet_v2.py``: its seeded init, its
Keras ``.h5`` import with offset auto-numbering, its pooled features) and
``extract_features`` for it and for a torchvision-weighted ResNet50
(``analysis/imagenet_baseline.py``), from arrays and from ``.h5`` patch
files.

The InceptionResNetV2 weights are the port's seeded init with batch norm
moved off the identity, written in the legacy Keras layout of the
distributed files with h5py, numbered from an offset as a file saved after
other models is, and with a with-top ``predictions`` layer. Features
within 1e-5 of the largest |feature| (fp32 summation order through about
240 convolutions). At most 3 tests: the JAX programs are the cost, queued
late.
"""
import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamorph_tpu.analysis import imagenet_baseline as jax_ib
from dynamorph_tpu.models.inception_resnet_v2 import \
    InceptionResNetV2 as JaxIRV2
from dynamorph_tpu.models import inception_resnet_v2 as jax_irv2
from dynamorph_tpu.seg import keras_import as jax_ki
from dynamorph_tpu_torch.analysis import imagenet_baseline as ib
from dynamorph_tpu_torch.models.inception_resnet_v2 import (
    InceptionResNetV2, import_keras_inception_resnet_v2)
from dynamorph_tpu_torch.models.jax_import import state_dict_from_jax
from dynamorph_tpu_torch.models.resnet_simclr import EncodeProject
from dynamorph_tpu_torch.seg import keras_import
from test_torch_train import _few_threads  # noqa: F401

FEAT_RTOL = 1e-5
OFFSET = 250


def _offset(name):
    """Keras's auto-name of a layer built ``OFFSET`` layers later."""
    for prefix in ("conv2d", "batch_normalization"):
        if name == prefix:
            return f"{prefix}_{OFFSET}"
        if name.startswith(prefix + "_") and name[len(prefix) + 1:].isdigit():
            return f"{prefix}_{int(name[len(prefix) + 1:]) + OFFSET}"
    return name


@pytest.fixture(scope="module")
def irv2(tmp_path_factory):
    """(.h5 path, the seeded Keras weights by layer)."""
    net = InceptionResNetV2(seed=3)
    r = np.random.RandomState(4)
    W = {}
    for name, m in net.named_children():
        if isinstance(m, torch.nn.Conv2d):
            lw = {"kernel:0": m.weight.detach().numpy().transpose(2, 3, 1, 0)}
            if m.bias is not None:
                lw["bias:0"] = (0.1 * r.randn(m.out_channels)) \
                    .astype(np.float32)
        else:
            n = m.num_features
            lw = {"beta:0": 0.1 * r.randn(n), "moving_mean:0":
                  0.1 * r.randn(n), "moving_variance:0": r.rand(n) + 0.5}
            lw = {k: v.astype(np.float32) for k, v in lw.items()}
        W[name] = lw
    path = str(tmp_path_factory.mktemp("irv2") / "irv2.h5")
    with h5py.File(path, "w") as f:
        for layer, lw in list(W.items()) + [("predictions", {
                "kernel:0": np.zeros((1536, 4), np.float32),
                "bias:0": np.zeros(4, np.float32)})]:
            name = _offset(layer)
            g = f.create_group(name)
            for k, v in lw.items():
                g.create_dataset(f"{name}/{k}", data=v)
    return path, W


def test_inception_init_import_and_features_match_jax(irv2, monkeypatch):
    """The port's ``init(seed)`` equals the JAX package's bit for bit (names
    and weights through ``state_dict_from_jax``); the import of an
    offset-numbered with-top ``.h5`` equals the JAX import bridged; the
    pooled features at 75² and 96² are within 1e-5 of max |feature| of the
    JAX package's; and a missing or an extra weighted layer is refused
    with the JAX package's message."""
    path, _ = irv2
    jp, js = JaxIRV2().init(3)
    init = state_dict_from_jax(jp, js, "InceptionResNetV2")
    own = InceptionResNetV2(seed=3).state_dict()
    assert sorted(init) == sorted(own)
    assert all(torch.equal(init[k], own[k]) for k in own)
    assert "block17_20_conv.bias" in own and "conv_7b_bn.running_var" in own

    net = import_keras_inception_resnet_v2(path)
    jnet, jp, js = jax_irv2.import_keras_inception_resnet_v2(path)
    bridged = state_dict_from_jax(jp, js, "InceptionResNetV2")
    got = net.state_dict()
    assert all(torch.equal(got[k], bridged[k]) for k in got)
    fn = jax.jit(lambda p, s, x: jnet.apply(p, s, x)[0])
    for size in (75, 96):
        x = np.random.RandomState(size).rand(2, 3, size, size) \
            .astype(np.float32) * 2 - 1
        want = np.asarray(fn(jp, js, jnp.asarray(x)))
        with torch.no_grad():
            feats = net.apply(torch.from_numpy(x)).numpy()
        assert feats.shape == want.shape == (2, 1536)
        assert np.abs(feats - want).max() <= FEAT_RTOL * np.abs(want).max()

    layers = keras_import.read_keras_layer_weights(path)
    for case in ("missing", "extra"):
        bad = dict(layers)
        if case == "missing":
            del bad["conv_7b"]
        else:
            bad["decoder_stage0a_conv"] = {"kernel": np.zeros((3, 3, 4, 4))}
        monkeypatch.setattr(keras_import, "read_keras_layer_weights",
                            lambda p: bad)
        monkeypatch.setattr(jax_ki, "read_keras_layer_weights",
                            lambda p: bad)
        with pytest.raises(ValueError) as mine:
            import_keras_inception_resnet_v2(path)
        with pytest.raises(ValueError) as theirs:
            jax_irv2.import_keras_inception_resnet_v2(path)
        assert str(mine.value) == str(theirs.value)


def _patch_files(root, patches):
    """The patches as the reference's ``.h5`` patch files (``masked_mat``
    (H, W, C))."""
    paths = []
    for i, p in enumerate(patches):
        paths.append(str(root / f"{i}_{i}.h5"))
        with h5py.File(paths[-1], "w") as f:
            f.create_dataset("masked_mat", data=np.transpose(p, (1, 2, 0)))
    return paths


def test_extract_features_inception_matches_jax(irv2, tmp_path):
    """``initiate_model_inception(weights=.h5)`` + ``extract_features``
    (mode "inception", 2 channels of 3 patches, batch 4 so the last batch
    is short) from arrays and from ``.h5`` patch files: (3, 2, 1536)
    within 1e-5 of max |feature| of the JAX package's."""
    path, _ = irv2
    model = ib.initiate_model_inception(weights=path, device="cpu")
    jm, jp, js = jax_ib.initiate_model_inception(weights=path)
    patches = np.random.RandomState(8).rand(3, 3, 80, 80) * 65535
    want = jax_ib.extract_features(patches, jm, jp, js, size=75,
                                   batch_size=4, mode="inception")
    files = _patch_files(tmp_path, patches)
    for src in (patches, files):
        got = ib.extract_features(src, model, size=75, batch_size=4,
                                  mode="inception")
        assert got.shape == want.shape == (3, 2, 1536)
        assert np.abs(got - want).max() <= FEAT_RTOL * np.abs(want).max()


def test_extract_features_resnet50_matches_jax(tmp_path):
    """``initiate_model(weights=<torchvision resnet50 state_dict>)`` +
    ``extract_features`` (mode "torch") from arrays and from ``.h5`` patch
    files: (3, 2, 2048) within 1e-5 of max |feature| of the JAX package's
    on the same saved state_dict."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(9)
        trunk = EncodeProject("ResNet50", num_inputs=3).convnet
    r = np.random.RandomState(9)
    sd = {}
    for k, v in trunk.state_dict().items():
        if k.endswith(("running_mean", "bias")):
            v = torch.from_numpy(0.1 * r.randn(*v.shape).astype(np.float32))
        elif k.endswith("running_var"):
            v = torch.from_numpy(r.uniform(0.5, 1.5, v.shape)
                                 .astype(np.float32))
        sd[k] = v
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), \
        torch.zeros(1000)
    weights = str(tmp_path / "resnet50.pt")
    torch.save(sd, weights)
    model = ib.initiate_model(weights, device="cpu")
    jm, jp, js = jax_ib.initiate_model(weights)
    patches = np.random.RandomState(10).rand(3, 2, 96, 96) * 65535
    want = jax_ib.extract_features(patches, jm, jp, js, size=64,
                                   batch_size=4)
    files = _patch_files(tmp_path, patches)
    for src in (patches, files):
        got = ib.extract_features(src, model, size=64, batch_size=4)
        assert got.shape == want.shape == (3, 2, 2048)
        assert np.abs(got - want).max() <= FEAT_RTOL * np.abs(want).max()
