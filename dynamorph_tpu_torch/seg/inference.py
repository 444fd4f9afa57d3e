"""Whole-map segmentation inference: the tiled offset ensemble and the
direct whole-frame pass — the port of ``dynamorph_tpu/seg/inference.py``
(reference NNsegmentation/data.py:350-482).

Every pass of the tiled ensemble sends all its tiles to the card as one
batch, as the JAX package does (for a 2048 x 2048 frame, 64 + 5 x 49 = 309
tile forwards in 6 batches). The JAX package pads each batch to a bucket so
XLA compiles few programs; PyTorch compiles nothing per shape, so the port
sends the tiles unpadded. The merge stays on the host in float64, in the
JAX package's order.

With several devices (``devices=``; by default this process's cards,
``core.mesh.local_devices()``, when the model is on the card) every batch
fans out over them as the JAX package shards it over its local mesh: a
pass's tiles are zero-padded to a bucket that is a multiple of the device
count, a direct batch of frames to a multiple of it, each device runs the
model's replica (``core.mesh.replica``) on an equal chunk, in order, and
the padding is trimmed. With one device the batch goes whole, unpadded.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

import torch

from ..core.constants import CHANNEL_MAX
from ..core.mesh import (fan_out_devices, map_chunks, pad_to_multiple,
                         replica, round_to_devices, zero_pad_rows)
from ..io.png import write_png
from .data import load_input, plot_prediction_prob

# the default tiles a padding bucket holds before it is rounded to the
# devices (dynamorph_tpu/seg/inference.py:22, :150); the config's
# segmentation_inference.batch_size sets it
TILE_BUCKET = 8


def _scaled_probabilities(model, x: torch.Tensor) -> torch.Tensor:
    """``Segment.predict_raw``'s arithmetic on a batch already on the
    model's device: cast to float32 and divide by CHANNEL_MAX there."""
    return model.probabilities(x.to(torch.float32) / CHANNEL_MAX)


def _predict_fanned_out(model, batch: np.ndarray, devices) -> np.ndarray:
    """``predict_raw`` of a host batch whose length is a multiple of the
    device count, an equal chunk a device."""
    return map_chunks(_scaled_probabilities, model, batch, devices)


def _predict_tiles(model, tiles: np.ndarray, devices=None,
                   batch_bucket: int = TILE_BUCKET) -> np.ndarray:
    """(n, C, x, y) raw tiles -> (n, n_classes, 1, x, y) probabilities.
    float64 tiles cross as float32; others in their own dtype (the model
    scales them on the device). One device takes the tiles in one batch;
    several take them zero-padded to a multiple of ``batch_bucket``, that
    bucket first raised to the device count and rounded down to a multiple
    of it (dynamorph_tpu/seg/inference.py:22-64), in equal chunks."""
    if tiles.dtype == np.float64:
        tiles = tiles.astype(np.float32)
    devices = fan_out_devices(devices, model.device)
    if len(devices) == 1:
        y = replica(model, devices[0]).predict_raw(tiles)
    else:
        bucket = round_to_devices(batch_bucket, len(devices))
        padded = zero_pad_rows(tiles, pad_to_multiple(len(tiles), bucket))
        y = _predict_fanned_out(model, padded, devices)[:len(tiles)]
    assert y.shape[1:] == (model.n_classes, 1) + tuple(model.input_shape[-2:])
    return y


def predict_whole_map_direct(inputs: np.ndarray, model,
                             frame_batch: int = 4,
                             devices=None) -> np.ndarray:
    """Whole-frame segmentation, ``frame_batch`` frames a device pass
    (dynamorph_tpu/seg/inference.py:92-147). The U-Net is fully
    convolutional, so a frame whose dims are multiples of 32 (the encoder's
    stride) runs through it directly. Over several devices ``frame_batch``
    is raised to their count and rounded down to a multiple of it
    (:113-123), and the last batch is zero-padded to a multiple of it.

    Args: inputs (T, C, Z, X, Y). Returns (T, n_classes, 1, X, Y).
    """
    n_frame, _, _, x_full, y_full = inputs.shape
    if x_full % 32 or y_full % 32:
        raise ValueError("frame dims must be multiples of 32 for direct mode")
    devices = fan_out_devices(devices, model.device)
    n_dev = len(devices)
    if n_dev > 1:
        frame_batch = round_to_devices(frame_batch, n_dev)
    outs = []
    for t0 in range(0, n_frame, frame_batch):
        batch = inputs[t0: t0 + frame_batch, :, 0]
        if batch.dtype == np.float64:
            batch = batch.astype(np.float32)
        if n_dev == 1:
            outs.append(replica(model, devices[0]).predict_raw(batch))
            continue
        padded = zero_pad_rows(batch, pad_to_multiple(len(batch), n_dev))
        outs.append(_predict_fanned_out(model, padded, devices)[:len(batch)])
    return np.concatenate(outs, 0)


def predict_whole_map(file_path, model, use_channels: Sequence[int] = (),
                      out_file_path: Optional[str] = None,
                      batch_size: int = TILE_BUCKET, n_supp: int = 5,
                      time_slices: int = 1, rng=None, mode: str = "tiled",
                      devices=None):
    """Segment a full 5-D stack (reference data.py:350-482).

    Args:
        file_path: path to a .npy / .h5 stack, or the array itself.
        model: a ``seg.model.Segment``.
        use_channels: channel indices for prediction (all if empty).
        out_file_path: output path; default <input>_NNProbabilities.npy.
        batch_size: the tiled mode's padding bucket over several devices
            (``_predict_tiles``' ``batch_bucket``); one device and the
            direct mode ignore it.
        n_supp: number of random-offset supplementary passes.
        time_slices: frames a prediction sees; more than 1 needs a
            ``SegmentWithMultipleSlice`` of as many slices, and gives
            ``T - time_slices + 1`` frames, each predicted from itself and
            the ones after it (tiled mode only).
        rng: np.random-like generator of the offsets; the global
            ``np.random`` when None, as the reference (data.py:440-441) and
            the JAX package use it, so one numpy seed gives both packages
            the same offsets.
        mode: "tiled" (reference-parity offset ensemble) or "direct"
            (single whole-frame pass, ``predict_whole_map_direct``).
        devices: the devices every batch fans out over (default: this
            process's cards when the model is on the card; see the module
            docstring).

    Returns the (T, n_classes, 1, X, Y) float64 probabilities for an array
    input; for a path it writes them, ``<input>.png`` and
    ``<input>_NNpred.png`` and returns None.
    """
    if mode not in ("tiled", "direct"):
        raise ValueError(f"unknown inference mode {mode!r}")
    if time_slices != 1:
        if len(model.input_shape) != 4 or \
                model.input_shape[1] != time_slices:
            raise ValueError(
                f"time_slices={time_slices} needs a SegmentWithMultipleSlice "
                f"of input_shape (c, {time_slices}, x, y); this model takes "
                f"{model.input_shape}")
        if mode != "tiled":
            raise ValueError("time_slices > 1 runs in the tiled mode only")
    if rng is None:
        rng = np.random
    inputs = load_input(file_path) if isinstance(file_path, str) else file_path
    if len(use_channels) == 0:
        use_channels = list(range(inputs.shape[1]))
    inputs = inputs[:, np.array(use_channels)]

    if mode == "direct":
        total_outputs = predict_whole_map_direct(inputs, model,
                                                 devices=devices)
        return _finish_whole_map(file_path, inputs, total_outputs,
                                 out_file_path)

    x_size, y_size = model.x_size, model.y_size
    n_classes = model.n_classes
    n_frame, n_channel, n_z, x_full, y_full = inputs.shape
    if x_full % x_size or y_full % y_size:
        raise ValueError(f"frame {x_full}x{y_full} is not a whole number of "
                         f"{x_size}x{y_size} tiles")
    if n_channel != model.n_channels:
        raise ValueError(f"{n_channel} channels for a model of "
                         f"{model.n_channels}")
    rows, cols = x_full // x_size, y_full // y_size

    total_outputs = []
    for t in range(n_frame - (time_slices - 1)):
        inp = inputs[t:t + time_slices]

        def tile_at(x0, y0):
            patch = inp[..., x0:x0 + x_size, y0:y0 + y_size]
            if time_slices == 1:
                return patch[0, :, 0]
            # (T, C, 1, x, y) -> (C, T, x, y): the time slices on z
            return patch[:, :, 0].transpose(1, 0, 2, 3)

        # base tiling pass
        tiles = np.stack([tile_at(r * x_size, c * y_size)
                          for r in range(rows) for c in range(cols)])
        outputs = _predict_tiles(model, tiles, devices, batch_size)
        concatenated = -np.ones((n_classes, 1, x_full, y_full))
        ct = 0
        for r in range(rows):
            for c in range(cols):
                concatenated[..., r * x_size:(r + 1) * x_size,
                             c * y_size:(c + 1) * y_size] = outputs[ct]
                ct += 1

        # random-offset supplementary passes, running-mean merged; a
        # single-tile row or column has no interior for offset tiles
        for i_supp in range(n_supp if rows > 1 and cols > 1 else 0):
            x_off = rng.randint(1, x_size)
            y_off = rng.randint(1, y_size)
            tiles = np.stack([
                tile_at(x_off + r * x_size, y_off + c * y_size)
                for r in range(rows - 1) for c in range(cols - 1)])
            outputs = _predict_tiles(model, tiles, devices, batch_size)
            supp = np.copy(concatenated)
            ct = 0
            for r in range(rows - 1):
                for c in range(cols - 1):
                    supp[..., (x_off + r * x_size):(x_off + (r + 1) * x_size),
                         (y_off + c * y_size):(y_off + (c + 1) * y_size)] = \
                        outputs[ct]
                    ct += 1
            concatenated = (concatenated * (i_supp + 1) + supp) / (i_supp + 2)
        total_outputs.append(concatenated)
    total_outputs = np.stack(total_outputs, 0)
    return _finish_whole_map(file_path, inputs, total_outputs, out_file_path)


def _finish_whole_map(file_path, inputs, total_outputs, out_file_path):
    """Write the probabilities and both previews for a path input
    (dynamorph_tpu/seg/inference.py:238-250); return them for an array."""
    if not isinstance(file_path, str):
        return total_outputs
    stem = os.path.splitext(file_path)[0]
    if out_file_path is None:
        out_file_path = stem + "_NNProbabilities"
    np.save(out_file_path, total_outputs)
    write_png(stem + ".png", inputs[0, 0, 0])
    plot_prediction_prob(total_outputs[0], stem + "_NNpred.png")
    return None
