"""Inputs made from the seed: patches that follow trajectories, their
relation matrix, and the starting weights.

The same seed gives the same inputs. Every seed gets the same multiset of
trajectory lengths (so the same work), in its own order. The bulk arrays
are drawn on the device with a ``torch.Generator`` in a few large calls;
the per-frame blob positions are a few numbers a patch, drawn on the host.

The patches are the blob generator of the port's chip script (smooth blobs
plus noise), extended to trajectories: a blob drifts from frame to frame of
its trajectory, at unit scale, as z-scored patches reach the trainer.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import scipy.sparse as sp
import torch

# rows a device call makes at a time (a well of 2,304 patches at 128^2)
CHUNK = 2304


def host_rng(seed: int, stream: int) -> np.random.Generator:
    """The host generator of one input stream of ``seed``."""
    return np.random.default_rng([int(seed), stream])


def device_generator(seed: int, device, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + stream) % (1 << 63))


def trajectory_lengths(n: int, lo: int, hi: int, seed: int) -> List[int]:
    """Lengths lo, lo + 1, ..., hi, lo, ... until they hold ``n`` frames
    (the remainder spread one frame at a time over the trajectories below
    ``hi``, from the last), in an order drawn from ``seed``."""
    lengths, total, length = [], 0, lo
    while total + length <= n:
        lengths.append(length)
        total += length
        length = lo if length == hi else length + 1
    rest = n - total
    if rest >= lo:
        lengths.append(rest)
        rest = 0
    i = len(lengths) - 1
    while rest:
        if lengths[i] < hi:
            lengths[i] += 1
            rest -= 1
        i = (i - 1) % len(lengths)
    order = host_rng(seed, 0).permutation(len(lengths))
    return [lengths[j] for j in order]


def relations(lengths: Sequence[int]) -> sp.csr_matrix:
    """The (n, n) relation matrix of trajectories laid out one after
    another: 2 for adjacent frames, 1 for the other pairs of a trajectory,
    nothing elsewhere and on the diagonal (the port's trainer input)."""
    rows, cols, vals = [], [], []
    start = 0
    for length in lengths:
        f = np.arange(start, start + length)
        a, b = np.meshgrid(f, f, indexing="ij")
        off = a != b
        rows.append(a[off])
        cols.append(b[off])
        vals.append(np.where(np.abs(a - b)[off] == 1, 2, 1))
        start += length
    n = start
    return sp.csr_matrix((np.concatenate(vals).astype(np.int64),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n))


def blob_tracks(lengths: Sequence[int], seed: int) -> np.ndarray:
    """(n, 3) float32: each frame's blob centre (x, y) and amplitude. A
    trajectory starts anywhere in the middle half and drifts by a small
    random step a frame."""
    rng = host_rng(seed, 1)
    out = []
    for length in lengths:
        start = rng.uniform(0.25, 0.75, 2)
        steps = rng.normal(0.0, 0.01, (length, 2))
        steps[0] = 0.0
        centre = np.clip(start + np.cumsum(steps, 0), 0.05, 0.95)
        amp = np.full((length, 1), rng.uniform(0.8, 1.2))
        out.append(np.concatenate([centre, amp], 1))
    return np.concatenate(out).astype(np.float32)


def patches(lengths: Sequence[int], size: int, seed: int,
            device) -> torch.Tensor:
    """(n, 2, size, size) float32 on ``device``: a Gaussian blob at each
    frame's centre in both channels, plus noise."""
    tracks = torch.from_numpy(blob_tracks(lengths, seed)).to(device)
    n = tracks.shape[0]
    gen = device_generator(seed, device, 2)
    grid = torch.arange(size, device=device, dtype=torch.float32) / size
    out = torch.empty((n, 2, size, size), dtype=torch.float32,
                      device=device)
    for i in range(0, n, CHUNK):
        t = tracks[i:i + CHUNK]
        dx = (grid[None, None, :] - t[:, 0, None, None]) ** 2
        dy = (grid[None, :, None] - t[:, 1, None, None]) ** 2
        blob = t[:, 2, None, None] * torch.exp(-(dx + dy) / 0.05)
        noise = torch.randn((len(t), 2, size, size), generator=gen,
                            device=device)
        out[i:i + CHUNK, 0] = 2.0 * blob + 0.3 * noise[:, 0] - 0.5
        out[i:i + CHUNK, 1] = 1.0 * blob + 0.3 * noise[:, 1] - 0.25
    return out


def weights(specs: Sequence[tuple], seed: int, device) -> Dict[str,
                                                                torch.Tensor]:
    """Starting weights by ``specs`` ((name, shape, init, bound), from the
    reference): one uniform draw on ``device`` for all of them, scaled per
    tensor."""
    sizes = [int(np.prod(s[1])) for s in specs]
    gen = device_generator(seed, device, 3)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out, offset = {}, 0
    for (name, shape, init, bound), size in zip(specs, sizes):
        if init == "uniform":
            out[name] = (flat[offset:offset + size] * bound).reshape(shape)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
        offset += size
    return out


def trainer_seed(seed: int) -> int:
    """The seed handed to the trainer (its host split draws from a
    ``RandomState``, which takes 32 bits)."""
    return int(seed) % (1 << 32)
