"""Segmentation inputs and previews: the port's copies of ``load_input``,
``preprocess`` and ``plot_prediction_prob`` from
``dynamorph_tpu/seg/data.py`` (reference NNsegmentation/data.py:17-346),
host-side numpy with the same semantics.
"""
from __future__ import annotations

import os

import numpy as np

from ..core.constants import CHANNEL_MAX
from ..io.png import write_png


def load_input(file_name: str) -> np.ndarray:
    """5-D (T, C, Z, X, Y) stack from .npy or .h5
    (reference data.py:17-24)."""
    ext = os.path.splitext(file_name)[1]
    if ext == ".h5":
        import h5py

        with h5py.File(file_name, "r") as f:
            dat = np.stack([f[key][()] for key in sorted(f.keys())], 0)
    elif ext == ".npy":
        dat = np.load(file_name)
    else:
        raise ValueError(f"Unsupported input {file_name}")
    if dat.ndim != 5:
        raise ValueError(
            "Please format inputs as 5-dimensional (t, c, z, x, y) arrays")
    return dat


def preprocess(patches, n_classes: int = 3, label_input: str = "prob",
               class_weights=None):
    """Patches -> (X, y+weight) arrays (reference data.py:260-325).

    X: (B, C, Z, X, Y) scaled to [0, 1]; labels: (B, n_classes + 1, 1, X, Y)
    with per-pixel weights appended as the last channel.
    """
    Xs, ys, ws = [], [], []
    if class_weights is None:
        class_weights = np.ones((n_classes,))
    n_channel, n_z, x_size, y_size = patches[0][0].shape
    for pair in patches:
        assert pair[0].shape == (n_channel, n_z, x_size, y_size)
        Xs.append(pair[0])
        if label_input:
            assert pair[1].shape[2:] == (x_size, y_size)
            assert pair[1].shape[1] == 1, \
                "Only support 2D segmentation, z dimension should be 1"
        if label_input == "prob":
            assert pair[1].shape[0] == n_classes
            ys.append(pair[1])
            ws.append(np.ones((1, 1, x_size, y_size)))
        elif label_input == "annotation":
            y = np.zeros((n_classes, 1, x_size, y_size))
            w = np.zeros((1, 1, x_size, y_size))
            for c in range(n_classes):
                x_pos, y_pos = np.where(pair[1] == (c + 1))[-2:]
                y[c, 0, x_pos, y_pos] = 1
                w[..., x_pos, y_pos] = class_weights[c]
            ys.append(y)
            ws.append(w)
        elif label_input is None:
            pass
        else:
            raise ValueError("Label type not recognized")

    Xs = np.stack(Xs, 0).astype(float) / CHANNEL_MAX
    if label_input is not None:
        ys = np.stack(ys, 0)
        ws = np.stack(ws, 0)
        return Xs, np.concatenate([ys, ws], 1)
    return Xs, None


def plot_prediction_prob(d1: np.ndarray, path: str) -> None:
    """Save a 3-class probability map as a BGRA PNG
    (reference data.py:328-346)."""
    assert d1.shape[0] == 3
    x_size, y_size = d1.shape[-2:]
    mat = np.zeros((x_size, y_size, 4))
    mat[:, :, :3] += d1[1, 0].reshape((x_size, y_size, 1)) * \
        np.array([200, 130, 0]).reshape((1, 1, 3))
    mat[:, :, -1] += d1[1, 0] * 255
    mat[:, :, :3] += d1[2, 0].reshape((x_size, y_size, 1)) * \
        np.array([75, 25, 230]).reshape((1, 1, 3))
    mat[:, :, -1] += d1[2, 0] * 255
    write_png(path, mat)
