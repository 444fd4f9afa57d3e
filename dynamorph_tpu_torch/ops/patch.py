"""Single-cell patch extraction on the device, the port of
``dynamorph_tpu/ops/patch.py`` (reference SingleCellPatch/
extract_patches.py:40-278).

All cells of one frame are processed in one batch of tensor operations: the
windows are gathered from the padded frame by index arithmetic (no
per-cell Python loop), the neighbour masks come from two batched disk
convolutions (``F.conv2d``, zero-padded "same"), and the masked
median-background fill follows. One plain PyTorch version serves CPU and
CUDA tensors alike; nothing is compiled per shape, so the cells go unpadded.

Exactness: the masks are 0/1 and a disk holds at most 441 taps, so the
convolutions count exactly in fp32 (and in TF32); the fill multiplies by
exactly 0 or 1. So every output equals the JAX package's bit for bit, and
the card's equals the CPU's. The disks are symmetric, so cross-correlation
(``F.conv2d``) is the convolution of ``scipy.signal.convolve2d``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import fp32_strict

# Label-map code of the out-of-image border. DBSCAN noise and background
# are -1, so the border has its own code (the reference pads the
# segmentation window with -1, extract_patches.py:241, :150).
OUT_OF_BOUNDS = -2


def disk_filter(size: int, strict: bool = False) -> np.ndarray:
    """Binary disk kernel. strict=False: r <= size//2 (reference filter1);
    strict=True: r < size//2 (reference filter2)."""
    c = size // 2
    yy, xx = np.mgrid[:size, :size]
    r = np.sqrt((yy - c) ** 2 + (xx - c) ** 2)
    return ((r < c) if strict else (r <= c)).astype(np.float32)


_FILTER1 = disk_filter(11, strict=False)  # masking of surrounding cells
_FILTER2 = disk_filter(21, strict=True)   # (un-)masking of the centre cell


def _conv_same(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Batched single-channel 2-D convolution, zero-padded "same".
    x: (N, H, W) float32 -> (N, H, W)."""
    # non_blocking: a small pageable upload is staged at once and does not
    # wait for the work queued on the stream
    k = torch.from_numpy(kernel).to(x.device, non_blocking=True)[None, None]
    return F.conv2d(x[:, None], k, padding=kernel.shape[0] // 2)[:, 0]


def labels_to_map(shape: Tuple[int, int], positions: np.ndarray,
                  positions_labels: np.ndarray) -> np.ndarray:
    """Scatter DBSCAN (pixel, label) lists into a full-frame int32 label map.
    Unlisted (background) pixels get -1, the code of DBSCAN noise: both mean
    "no cell here" (reference instance_clustering.py:89-96)."""
    lab = np.full(shape, -1, dtype=np.int32)
    if len(positions):
        lab[positions[:, 0], positions[:, 1]] = positions_labels
    return lab


def _windows(frame: torch.Tensor, centers: torch.Tensor,
             window_size: int) -> torch.Tensor:
    """(..., Hp, Wp) padded frame -> (N, ..., window, window) windows whose
    top-left corners are ``centers`` (padded coordinates), clamped to stay
    inside the frame as ``lax.dynamic_slice`` clamps them."""
    hp, wp = frame.shape[-2:]
    y = centers[:, 0].clamp(0, hp - window_size)
    x = centers[:, 1].clamp(0, wp - window_size)
    offs = torch.arange(window_size, device=frame.device)
    rows = (y[:, None] + offs)[:, :, None]                  # (N, W, 1)
    cols = (x[:, None] + offs)[:, None, :]                  # (N, 1, W)
    out = frame[..., rows, cols]                            # (..., N, W, W)
    return out.movedim(-3, 0)


def extract_cell_patches(raw: torch.Tensor, labels: torch.Tensor,
                         centers: torch.Tensor, cell_ids: torch.Tensor,
                         bg_fill: torch.Tensor, window_size: int = 256
                         ) -> Dict[str, torch.Tensor]:
    """All cells of one frame -> patches and masks, on the tensors' device.

    Args:
        raw: (C, H, W) float32 frame (z squeezed).
        labels: (H, W) int32 instance label map (-1 = no cell).
        centers: (N, 2) integer cell centres (y, x).
        cell_ids: (N,) integer cell id of each centre.
        bg_fill: (C,) per-channel median background fill values.
        window_size: patch size.

    Returns a dict of
        mat:        (N, C, window, window) raw windows (0-padded at borders)
        masked_mat: (N, C, window, window) neighbour-masked windows
        tm:         (N, window, window) uint8 target-cell mask
        tm2:        (N, window, window) uint8 enlarged target mask
    """
    half = window_size // 2
    with fp32_strict():
        raw_p = F.pad(raw, (half, half, half, half))
        lab_p = F.pad(labels, (half, half, half, half),
                      value=OUT_OF_BOUNDS)
        centers = centers.to(device=raw.device, dtype=torch.int64)
        raw_w = _windows(raw_p, centers, window_size)      # (N, C, W, W)
        lab_w = _windows(lab_p, centers, window_size)      # (N, W, W)
        cid = cell_ids.to(device=raw.device, dtype=lab_w.dtype)[:, None,
                                                                None]
        other = ((lab_w != cid) & (lab_w >= 0)).float()
        target = (lab_w == cid).float()

        remove = torch.sign(_conv_same(other, _FILTER1))
        tm2 = torch.sign(_conv_same(target, _FILTER2))
        # the target mask overrides the remove mask (extract_patches.py:148)
        remove = ((remove - tm2) > 0).float()
        # the out-of-image border is always masked (extract_patches.py:150)
        remove = torch.where(lab_w == OUT_OF_BOUNDS, 1.0, remove)

        rm = remove[:, None]                                 # (N, 1, W, W)
        masked = raw_w * (1.0 - rm) + bg_fill[None, :, None, None] * rm
    return {"mat": raw_w, "masked_mat": masked,
            "tm": target.to(torch.uint8), "tm2": tm2.to(torch.uint8)}


def median_background(raw: torch.Tensor, bg_prob: torch.Tensor,
                      thr: float = 0.9) -> torch.Tensor:
    """Per-channel median of the pixels whose background probability is
    above ``thr`` (reference extract_patches.py:224-226), on the tensors'
    device. raw: (C, H, W) float32; bg_prob: (H, W) float32. Returns (C,).

    ``jnp.nanmedian`` (and the reference's ``np.median``) return the mean
    of the two middle values of an even count; ``torch.median`` would
    return the lower one. So the masked values are sorted (NaN last) and
    the two middle ones averaged as ``jnp.nanmedian`` does,
    ``(lo + hi) * 0.5`` in float32. No background pixel gives NaN.
    """
    mask = bg_prob > torch.tensor(thr, dtype=bg_prob.dtype)
    vals = torch.where(mask[None], raw, torch.nan).reshape(raw.shape[0], -1)
    vals = torch.sort(vals, dim=1).values
    count = mask.sum()
    lo = ((count - 1) // 2).clamp(min=0)
    hi = (count // 2).clamp(min=0)
    mid = vals[:, torch.stack([lo, hi])]                    # (C, 2)
    return (mid[:, 0] + mid[:, 1]) * 0.5


def pack_mask_bits(mask: torch.Tensor) -> torch.Tensor:
    """Pack an (H, W) bool mask into (H, W // 8) uint8, little-endian bit
    order, on the mask's device (``pack_mask_bits``,
    dynamorph_tpu/ops/patch.py:119-130): ``np.unpackbits(...,
    bitorder="little")`` inverts it on the host. The fused stage ships the
    foreground to the host at 1 bit a pixel. W must be a multiple of 8."""
    h, w = mask.shape
    if w % 8:
        raise ValueError(f"pack_mask_bits: width {w} is not a multiple of 8")
    bits = mask.reshape(h, w // 8, 8).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=mask.device)
    return torch.sum(bits << shifts, dim=-1, dtype=torch.uint8)


def scatter_label_map(coords: torch.Tensor, labels: torch.Tensor,
                      shape: Tuple[int, int]) -> torch.Tensor:
    """(pixel, label) lists -> an (H, W) int32 label map on their device,
    -1 where no pixel is listed: the device dual of ``labels_to_map``
    (``scatter_label_map``, dynamorph_tpu/ops/patch.py:133-142).

    coords: (N, 2) integer (y, x); labels: (N,) integer. As in the JAX
    package (``mode="drop"``), a negative index counts from the end and a
    row still outside the map is dropped: it is sent to one spare slot past
    the map, so no index is out of bounds and nothing syncs with the host.
    """
    h, w = shape
    y = coords[:, 0].to(torch.int64)
    x = coords[:, 1].to(torch.int64)
    y = torch.where(y < 0, y + h, y)
    x = torch.where(x < 0, x + w, x)
    inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
    flat = torch.where(inside, y * w + x, h * w)
    lab = torch.full((h * w + 1,), -1, dtype=torch.int32,
                     device=coords.device)
    lab.scatter_(0, flat, labels.to(torch.int32))
    return lab[:h * w].view(h, w)
