"""ImageNet-pretrained baseline feature extractors: the port of
``dynamorph_tpu/analysis/imagenet_baseline.py`` (reference
HiddenStateExtractor/naive_imagenet.py:29-129).

Each grayscale channel of a single-cell patch is resized to 224 x 224
(``ops/geometry.py::resize``, cv2's float64 INTER_LINEAR bit for bit),
replicated to 3 channels and normalised, then encoded to pooled features
by a ResNet trunk (``initiate_model``, torchvision weights) or
InceptionResNetV2 (``initiate_model_inception``, Keras weights). The
features are the baseline the learned latents are compared with.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.constants import CHANNEL_MAX
from ..core.device import resolve_device
from ..io import hdf5
from ..models.common import load_torchvision_weights
from ..models.inception_resnet_v2 import (InceptionResNetV2,
                                          import_keras_inception_resnet_v2)
from ..models.resnet_simclr import EncodeProject
from ..ops.geometry import resize

# torchvision ImageNet normalization constants
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def read_file_path(root: str) -> List[str]:
    """All .h5 files under ``root`` (reference naive_imagenet.py:11-26)."""
    files = []
    for dir_name, _, fs in os.walk(root):
        for f in fs:
            if f.endswith(".h5"):
                files.append(os.path.join(dir_name, f))
    return files


def preprocess_patch(dat: np.ndarray, cs=(0, 1),
                     channel_max=CHANNEL_MAX) -> np.ndarray:
    """The selected channels scaled to [0, 1] (reference
    naive_imagenet.py:106-117 without the x255)."""
    dat = np.asarray(dat)[np.asarray(cs)].astype(float)
    return dat / channel_max


def preprocess(patch: np.ndarray, cs: Optional[Sequence[int]] = (0, 1),
               channel_max=CHANNEL_MAX, size: int = 224,
               mode: str = "torch") -> np.ndarray:
    """One (C, H, W) patch -> (len(cs), 3, size, size) float32 network
    inputs: each selected channel resized to size x size in float64,
    scaled to [0, 1], replicated to 3 channels, then normalised:
    ``mode="torch"`` by torchvision's ImageNet mean and std (the ResNet
    weights), ``mode="inception"`` to [-1, 1] (Keras's 'tf'
    ``preprocess_input`` after the reference's x255, naive_imagenet.py:60,
    85-87)."""
    patch = np.asarray(patch)
    if cs is None:
        cs = range(patch.shape[0])
    stacks = []
    for c in cs:
        g = resize(patch[c].astype(np.float64), (size, size))
        g = g / np.asarray(channel_max, np.float64)
        rgb = np.stack([g] * 3, 0).astype(np.float32)
        if mode == "inception":
            rgb = rgb * 2.0 - 1.0
        else:
            rgb = (rgb - IMAGENET_MEAN[:, None, None]) \
                / IMAGENET_STD[:, None, None]
        stacks.append(rgb)
    return np.stack(stacks, 0)


def initiate_model(weights=None, arch: str = "ResNet50",
                   device: Union[str, torch.device] = "cuda"
                   ) -> EncodeProject:
    """The ResNet feature extractor (reference naive_imagenet.py:29-45): an
    ``EncodeProject(arch, num_inputs=3)`` whose ``encode_batched(...,
    out="h")`` gives the pooled trunk features (2048-d for ResNet50).

    ``weights``: a torchvision-format ``resnet{18,50,101,152}`` state_dict
    (a dict of tensors or arrays, or the path of a saved one), mapped onto
    ``convnet.*``; ``fc.*`` is ignored and every trunk tensor must be in
    it. None keeps the seeded random initialisation."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = EncodeProject(arch=arch, num_inputs=3)
    if weights is not None:
        load_torchvision_weights(model.convnet, weights, "weights",
                                 f"{arch} trunk")
    return model.to(resolve_device(device))


def initiate_model_inception(weights: Optional[str] = None,
                             pooling: Optional[str] = "avg",
                             device: Union[str, torch.device] = "cuda"
                             ) -> InceptionResNetV2:
    """The InceptionResNetV2 feature extractor (reference
    naive_imagenet.py:47-60), 1536-d pooled features; use it with
    ``extract_features(..., mode="inception")``.

    ``weights``: a keras_applications InceptionResNetV2 ``.h5`` (the legacy
    layout of the distributed ``weights='imagenet'`` files); None draws the
    glorot init of seed 0."""
    model = import_keras_inception_resnet_v2(weights, pooling=pooling) \
        if weights is not None else InceptionResNetV2(pooling=pooling)
    return model.to(resolve_device(device))


def extract_features(patches, model, cs: Optional[Sequence[int]] = (0, 1),
                     channel_max=CHANNEL_MAX, batch_size: int = 128,
                     size: int = 224, mode: str = "torch") -> np.ndarray:
    """Patches -> pooled ImageNet features, on the model's device (the
    working equivalent of the reference's ``predict``,
    naive_imagenet.py:88-129).

    ``patches``: a (N, C, H, W) array, or a list of ``.h5`` patch files
    whose ``masked_mat`` is (H, W, C) (the reference's layout). Returns
    (N, len(cs), feat_dim) float32."""
    xs = []
    for p in patches:
        if isinstance(p, (str, os.PathLike)):
            p = np.transpose(hdf5.read(os.fspath(p), "masked_mat"),
                             (2, 0, 1))
        xs.append(preprocess(p, cs=cs, channel_max=channel_max, size=size,
                             mode=mode))
    x = np.concatenate(xs, 0)              # (N * channels, 3, size, size)
    feats = model.encode_batched(x, out="h", batch_size=batch_size)
    return feats.reshape(len(xs), x.shape[0] // len(xs), -1)
