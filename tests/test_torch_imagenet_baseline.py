"""The ImageNet baselines' host side (``analysis/imagenet_baseline.py``,
``ops/geometry.py::resize`` on float64) against the installed cv2 and the
JAX package on the CPU, and the torchvision weight map of
``initiate_model``.

``resize`` must equal ``cv2.resize`` bit for bit on float64 at the patch
sizes the pipeline writes (128 and 256, to 224), at odd and non-square
factors, and at an exact 2x shrink; ``preprocess`` must then equal the JAX
package's (which calls cv2) bit for bit in both modes. The networks
themselves are held against the JAX package in
``tests/test_torch_imagenet_models.py``.
"""
import cv2
import numpy as np
import pytest
import torch

from dynamorph_tpu.analysis import imagenet_baseline as jax_ib
from dynamorph_tpu_torch.analysis import imagenet_baseline as ib
from dynamorph_tpu_torch.models.resnet_simclr import EncodeProject
from dynamorph_tpu_torch.ops.geometry import resize
from test_torch_train import _few_threads  # noqa: F401


@pytest.mark.parametrize("src,dst", [
    ((128, 128), (224, 224)), ((256, 256), (224, 224)),
    ((97, 101), (224, 224)), ((75, 75), (224, 224)),
    ((300, 300), (224, 224)), ((448, 448), (224, 224)),
    ((33, 47), (60, 71)), ((64, 50), (21, 37))])
def test_resize_float64_matches_cv2(src, dst):
    """cv2 5.0's float64 INTER_LINEAR: positions, fractions and both
    passes as fused multiply-adds in float64, bit-equal on uint16-range
    and on signed data."""
    r = np.random.RandomState(src[0] * 1000 + dst[1])
    for img in (r.rand(*src) * 65535, r.randn(*src) * 3.0):
        want = cv2.resize(img, (dst[1], dst[0]))
        got = resize(img, (dst[1], dst[0]))
        assert got.dtype == want.dtype == np.float64
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["torch", "inception"])
@pytest.mark.parametrize("size", [128, 256, 97])
def test_preprocess_matches_jax(mode, size):
    """(C, H, W) patches of uint16-range floats -> (2, 3, 224, 224) float32
    inputs, bit-equal to the JAX package's (cv2's resize)."""
    r = np.random.RandomState(size)
    patch = r.rand(3, size, size) * 65535
    got = ib.preprocess(patch, cs=(0, 2), mode=mode)
    want = jax_ib.preprocess(patch, cs=(0, 2), mode=mode)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (2, 3, 224, 224)
    np.testing.assert_array_equal(got, want)


def test_preprocess_patch_and_read_file_path(tmp_path):
    r = np.random.RandomState(3)
    dat = r.rand(3, 8, 8) * 65535
    np.testing.assert_array_equal(ib.preprocess_patch(dat, cs=(2, 0)),
                                  jax_ib.preprocess_patch(dat, cs=(2, 0)))
    for name in ("a/x.h5", "a/b/y.h5", "c.txt", "z.h5"):
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).write_bytes(b"")
    assert sorted(ib.read_file_path(str(tmp_path))) == \
        sorted(jax_ib.read_file_path(str(tmp_path)))
    np.testing.assert_array_equal(
        ib.preprocess(dat, cs=None, size=16),
        jax_ib.preprocess(dat, cs=None, size=16))


def _torchvision_resnet18(seed):
    """A torchvision-format resnet18 state_dict (``conv1``, ``bn1``,
    ``layer*``, ``fc``) with 3 input channels, seeded."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        trunk = EncodeProject("ResNet18", num_inputs=3).convnet
    sd = {k: v.clone() for k, v in trunk.state_dict().items()}
    sd["fc.weight"] = torch.randn(1000, 512)
    sd["fc.bias"] = torch.randn(1000)
    return sd


@pytest.mark.parametrize("given", ["dict", "path"])
def test_initiate_model_maps_torchvision_weights(given, tmp_path):
    """``initiate_model`` loads a torchvision state_dict (a dict or a saved
    file) onto ``convnet.*`` exactly, ignoring ``fc.*``; a state_dict
    missing a trunk tensor is refused."""
    sd = _torchvision_resnet18(7)
    weights = sd
    if given == "path":
        weights = str(tmp_path / "resnet18.pt")
        torch.save(sd, weights)
    model = ib.initiate_model(weights, arch="ResNet18", device="cpu")
    for k, v in model.convnet.state_dict().items():
        assert torch.equal(v, sd[k]), k
    bad = {k: v for k, v in sd.items() if k != "layer3.1.bn2.running_var"}
    with pytest.raises(ValueError, match="lacks 1 ResNet18 trunk"):
        ib.initiate_model(bad, arch="ResNet18", device="cpu")
