"""Trajectory visualisation: bounding-box GIFs, the port of
``dynamorph_tpu/track/visualize.py`` (reference
SingleCellPatch/generate_trajectories.py:326-369): the field of view resized
to 512 x 512 with a red box around the tracked cell, an animated GIF
through PIL (imported here only).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..ops.geometry import resize


def save_traj_bbox(trajectory: Dict[int, int],
                   trajectory_positions: Dict[int, np.ndarray],
                   image_stack: np.ndarray, path: str) -> None:
    """Render one trajectory as a GIF.

    Args:
        trajectory: {t_point: cell_id}.
        trajectory_positions: {t_point: (x, y) centre in frame coordinates}.
        image_stack: (T, X, Y, C) uint8 or uint16 raw stack; channel 0 is
            drawn (``ops.geometry.resize``, cv2's bilinear).
        path: output .gif path.
    """
    from PIL import Image

    full_x, full_y = image_stack.shape[1], image_stack.shape[2]
    t_keys = sorted(trajectory.keys())
    frames = np.zeros((len(t_keys), 512, 512))
    for i, k in enumerate(t_keys):
        frames[i] = resize(image_stack[k, :, :, 0], (512, 512), "linear")
    frames = np.stack([frames] * 3, 3) / 65535.0

    red = np.array([1.0, 0.0, 0.0]).reshape((1, 1, 3))
    # per-axis scales, so boxes land right on non-square frames
    scale = np.array([full_x / 512, full_y / 512])
    for i, k in enumerate(t_keys):
        c = np.asarray(trajectory_positions[k]) / scale
        br = [(max(c[0] - 16.0, 0), min(c[0] + 16.0, 512)),
              (max(c[1] - 16.0, 0), min(c[1] + 16.0, 512))]
        for x in (br[0][0], br[0][1]):
            x_ = (int(max(x - 1.0, 0)), int(min(x + 1.0, 512)))
            frames[i, x_[0]:x_[1], int(br[1][0]):int(br[1][1])] = red
        for y in (br[1][0], br[1][1]):
            y_ = (int(max(y - 1.0, 0)), int(min(y + 1.0, 512)))
            frames[i, int(br[0][0]):int(br[0][1]), y_[0]:y_[1]] = red

    pages = [Image.fromarray((f * 255).astype("uint8")) for f in frames]
    pages[0].save(path, save_all=True, append_images=pages[1:],
                  duration=200, loop=0)
