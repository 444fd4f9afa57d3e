"""Segmentation inputs, training patches and previews: the port of
``dynamorph_tpu/seg/data.py`` (reference NNsegmentation/data.py:17-346),
host-side numpy with the same semantics.

The random sampler draws from the global ``np.random`` in the JAX
package's order (frame, x, y, angle, mirror coin), so one seed gives both
packages the same patches. Its rotation is ``ops/geometry.py``'s
``warp_affine`` on float64, cv2's fixed-point arithmetic, run by torch on
the CPU.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..core.constants import CHANNEL_MAX
from ..io import hdf5
from ..io.png import write_png
from ..ops.geometry import channel_first, flip, rotation_matrix_2d, \
    warp_image


def load_input(file_name: str) -> np.ndarray:
    """5-D (T, C, Z, X, Y) stack from .npy or .h5
    (reference data.py:17-24)."""
    ext = os.path.splitext(file_name)[1]
    if ext == ".h5":
        with hdf5.File(file_name) as f:
            dat = np.stack([f.read(key) for key in sorted(f.keys())], 0)
    elif ext == ".npy":
        dat = np.load(file_name)
    else:
        raise ValueError(f"Unsupported input {file_name}")
    if dat.ndim != 5:
        raise ValueError(
            "Please format inputs as 5-dimensional (t, c, z, x, y) arrays")
    return dat


def load_label(file_name: str) -> np.ndarray:
    """A label stack from .npy or .h5 (its first dataset)."""
    ext = os.path.splitext(file_name)[1]
    if ext == ".h5":
        with hdf5.File(file_name) as f:
            return f.read(f.keys()[0])
    if ext == ".npy":
        return np.load(file_name)
    raise ValueError(f"Unsupported label {file_name}")


def rotate_image(mat: np.ndarray, angle: float, image_center=None):
    """Rotate a (C, Z, X, Y) image by ``angle`` degrees with expanded
    bounds (reference data.py:56-86): every channel and slice is one
    channel of one warp."""
    n_channel, n_z, height, width = mat.shape
    if image_center is None:
        image_center = (width / 2, height / 2)
    rot = rotation_matrix_2d(image_center, angle, 1.0)
    abs_cos, abs_sin = abs(rot[0, 0]), abs(rot[0, 1])
    bound_w = int(height * abs_sin + width * abs_cos)
    bound_h = int(height * abs_cos + width * abs_sin)
    rot[0, 2] += bound_w / 2 - image_center[0]
    rot[1, 2] += bound_h / 2 - image_center[1]
    return channel_first(warp_image, mat, rot, (bound_w, bound_h))


def _load_pair(input_file, label_file, use_channels):
    input_f = input_file if isinstance(input_file, np.ndarray) \
        else load_input(input_file)
    label_f = label_file if isinstance(label_file, np.ndarray) \
        else load_label(label_file)
    if len(use_channels) == 0:
        use_channels = list(range(input_f.shape[1]))
    return input_f[:, np.array(use_channels)], label_f


def generate_patches(input_file, label_file, use_channels=(),
                     label_input: str = "prob", n_patches: int = 1000,
                     x_size: int = 256, y_size: int = 256,
                     rotate: bool = False, mirror: bool = False,
                     seed: Optional[int] = None) -> List:
    """Random augmented training patches (reference data.py:89-188):
    ``[input (C, Z, x, y) float64, label]`` pairs; with ``rotate`` each
    is cut from a window of ``x_size / sqrt(2)`` around its centre, rotated
    with expanded bounds and cropped in the middle; with ``mirror`` a coin
    flips it left-right. "annotation" labels skip patches with one label
    value and come back as int."""
    input_f, label_f = _load_pair(input_file, label_file, use_channels)
    if label_input not in ("prob", "annotation"):
        # anything else would loop forever (nothing is ever appended)
        raise ValueError(f"Label type {label_input!r} not recognized")
    n_frame, _, _, x_full, y_full = input_f.shape
    x_margin = int(x_size / np.sqrt(2))
    y_margin = int(y_size / np.sqrt(2))

    data = []
    if seed is not None:
        np.random.seed(seed)
    while len(data) < n_patches:
        t_point = np.random.randint(n_frame)
        x_center = np.random.randint(x_size / np.sqrt(2),
                                     x_full - x_size / np.sqrt(2))
        y_center = np.random.randint(y_size / np.sqrt(2),
                                     y_full - y_size / np.sqrt(2))
        if rotate:
            angle = np.random.rand() * 360
            xs = slice(x_center - x_margin, x_center + x_margin)
            ys = slice(y_center - y_margin, y_center + y_margin)
            p_in = rotate_image(np.array(input_f[t_point, ..., xs, ys])
                                .astype(float), angle)
            p_lb = rotate_image(np.array(label_f[t_point, ..., xs, ys])
                                .astype(float), angle)
            cx, cy = p_in.shape[-2] // 2, p_in.shape[-1] // 2
            crop = (..., slice(cx - x_size // 2, cx + x_size // 2),
                    slice(cy - y_size // 2, cy + y_size // 2))
            patch_X, patch_y = p_in[crop], p_lb[crop]
        else:
            xm, ym = x_size // 2, y_size // 2
            crop = (t_point, ..., slice(x_center - xm, x_center + xm),
                    slice(y_center - ym, y_center + ym))
            patch_X = np.array(input_f[crop]).astype(float)
            patch_y = np.array(label_f[crop]).astype(float)
        if mirror and np.random.rand() > 0.5:
            patch_X = channel_first(flip, patch_X, 1)
            patch_y = channel_first(flip, patch_y, 1)

        if label_input == "prob":
            data.append([patch_X, patch_y])
        else:
            if len(np.unique(patch_y)) == 1:
                continue  # no annotation in this patch
            data.append([patch_X, patch_y.astype(int)])
    return data


def generate_ordered_patches(input_file, label_file, use_channels=(),
                             label_input: str = "prob", x_size: int = 256,
                             y_size: int = 256, time_slices: int = 1
                             ) -> List:
    """Tiled (non-random) patches (reference data.py:191-257): frames
    whose labels hold one value are skipped, and with ``time_slices`` > 1
    each input is the (T, C, Z, x, y) run of frames from its own."""
    input_f, label_f = _load_pair(input_file, label_file, use_channels)
    n_frame, _, _, x_full, y_full = input_f.shape
    n_x, n_y = x_full // x_size, y_full // y_size
    data = []
    for t_point in range(n_frame - (time_slices - 1)):
        if len(np.unique(label_f[t_point])) == 1:
            continue
        for i in range(n_x):
            for j in range(n_y):
                xs = slice(i * x_size, (i + 1) * x_size)
                ys = slice(j * y_size, (j + 1) * y_size)
                if time_slices == 1:
                    patch_X = np.array(input_f[t_point, ..., xs, ys])
                else:
                    patch_X = np.array(
                        input_f[t_point:(t_point + time_slices), ..., xs, ys])
                patch_X = patch_X.astype(float)
                patch_y = np.array(label_f[t_point, ..., xs, ys])
                if label_input == "prob":
                    patch_y = patch_y.astype(float)
                elif label_input == "annotation":
                    patch_y = patch_y.astype(int)
                    if len(np.unique(patch_y)) == 1:
                        continue
                data.append([patch_X, patch_y])
    return data


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
