"""Segment: the U-Net segmentation model wrapper, inference half — the port
of ``predict``, ``save`` and ``load`` of ``dynamorph_tpu/seg/model.py``
(reference NNsegmentation/models.py:32-203).

Weights are a ``model.pt`` state_dict of ``models/unet.py`` names, as a
file or inside a directory. A JAX-trained U-Net crosses with
``models.jax_import.state_dict_from_jax(params, state, "UNet")``.
``fit`` and ``SegmentWithMultipleSlice`` are not ported yet.
"""
from __future__ import annotations

import os
from typing import Union

import numpy as np
import torch

from ..core.constants import CHANNEL_MAX
from ..core.device import fp32_strict, resolve_device
from ..models.jax_import import load_reference_checkpoint
from ..models.unet import UNet
from .data import preprocess

_KERAS_NOT_PORTED = (
    "{path} is a Keras weight file: importing reference-trained Keras "
    "U-Nets (models/unet_keras.py, seg/keras_import.py) is not ported yet "
    "(ROADMAP slice C, unet_keras.py + seg/keras_import.py); use "
    "dynamorph_tpu.seg.model.Segment for it")


class Segment:
    """U-Net semantic segmentation model (reference NNsegmentation/models.py:32).

    Args:
        input_shape: (c, x, y), the reference's channels-first input spec.
        n_classes: number of prediction classes.
        seed: seed of the random initial weights.
        device: where the network runs ("cuda" unless the caller asks for
            the CPU; without a card "cuda" raises).
    """

    def __init__(self, input_shape=(2, 256, 256), n_classes: int = 3,
                 seed: int = 0, device: Union[str, torch.device] = "cuda"):
        self.input_shape = tuple(input_shape)
        self.n_channels = self.input_shape[0]
        self.x_size, self.y_size = self.input_shape[-2:]
        self.n_classes = n_classes
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.net = UNet(n_channels=self.n_channels, n_classes=n_classes)
        self.net.to(self.device)

    def probabilities(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, x, y) float32 on the model's device, in [0, 1] ->
        (B, n_classes, 1, x, y) softmax probabilities, full fp32."""
        with torch.no_grad(), fp32_strict():
            return torch.softmax(self.net(x), dim=1)[:, :, None]

    def predict_raw(self, x: np.ndarray) -> np.ndarray:
        """Raw intensities (B, C, x, y) -> probabilities as numpy. ``x``
        uploads in its own dtype (uint16 at half the bytes of float32); the
        cast to float32 and the divide by CHANNEL_MAX run on the device, as
        ``_scaled_predict_fn`` does (dynamorph_tpu/seg/inference.py:68-89)."""
        t = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return self.probabilities(t.to(torch.float32) / CHANNEL_MAX) \
            .cpu().numpy()

    def predict(self, patches, label_input: str = "prob") -> np.ndarray:
        """(B, n_classes, 1, x, y) softmax probabilities
        (reference models.py:159-182). A list of patch pairs is scaled by
        ``preprocess``; an array goes in as it is."""
        if isinstance(patches, list):
            X, _ = preprocess(patches, label_input=label_input)
            X = X.reshape((-1,) + self.input_shape)
        elif isinstance(patches, np.ndarray):
            X = patches.reshape((-1,) + self.input_shape)
        else:
            raise ValueError("Input format not supported")
        x = torch.from_numpy(X.astype(np.float32)).to(self.device)
        y = self.probabilities(x).cpu().numpy()
        assert y.shape[1:] == (self.n_classes, 1, self.x_size, self.y_size)
        return y

    def save(self, path: str) -> None:
        """Write the state_dict to ``path`` if it ends in ``.pt``, else to
        ``path/model.pt``."""
        if not path.endswith(".pt"):
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, "model.pt")
        torch.save(self.net.state_dict(), path)

    def load(self, path: str) -> None:
        """Load a ``model.pt`` state_dict (strict), given as the file or a
        directory that holds it."""
        if path.endswith((".h5", ".hdf5")):
            raise NotImplementedError(_KERAS_NOT_PORTED.format(path=path))
        if os.path.isdir(path):
            if not os.path.exists(os.path.join(path, "model.pt")):
                raise ValueError(
                    f"{path} is a directory without a model.pt; orbax "
                    "checkpoint directories need the JAX package: restore "
                    "it there and bridge the (params, state) with "
                    "dynamorph_tpu_torch.models.jax_import."
                    "state_dict_from_jax(params, state, 'UNet')")
            path = os.path.join(path, "model.pt")
        self.net.load_state_dict(load_reference_checkpoint(path),
                                 strict=True)
