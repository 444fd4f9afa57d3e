"""Triplet dataset sampling (host-side), the port's copy of
``dynamorph_tpu/train/triplet_data.py``.

Behavioral spec: reference pipeline/train_utils.py:63-171 (TripletDataset:
each drawn index yields n_sample patches of the same label — the anchor plus
n_sample-1 resampled positives) and run_training.py:323-331 (augment_img:
random flip + rot90 per patch). Replaces torch DataLoader with a plain numpy
batcher; batches are flattened to (batch_size_adj * n_sample, C, H, W) like
the reference's collate + cat (run_training.py:596-598).

Host RNG streams: with ``rng=None`` the flips, rotations and positive-set
draws come from the global ``np.random``, in the order the JAX package
takes them, so one ``np.random.seed`` gives both packages the same batches
(``run_training``'s ResNet branch builds its datasets that way).
"""
from __future__ import annotations

from typing import Callable, Iterator, Tuple

import numpy as np


def augment_img(img: np.ndarray, rng=None) -> np.ndarray:
    """Random flip (none/axis1/axis2) + random rot90 of a (C, H, W) patch
    (reference run_training.py:323-331)."""
    if rng is None:
        rng = np.random
    flip_idx = rng.choice([0, 1, 2])
    if flip_idx != 0:
        img = np.flip(img, axis=flip_idx)
    rot_idx = int(rng.choice([0, 1, 2, 3]))
    return np.rot90(img, k=rot_idx, axes=(1, 2))


class TripletDataset:
    """Index-based positive-set sampler (reference train_utils.py:63-171)."""

    def __init__(self, labels: np.ndarray, data_fn: Callable[[int], np.ndarray],
                 n_sample: int, rng=None):
        self.labels = np.asarray(labels)
        self.data_fn = data_fn
        self.size = len(self.labels)
        self.n_sample = n_sample
        self.rng = rng if rng is not None else np.random

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        if not (0 <= index < len(self)):
            raise IndexError(
                f"Index {index} is out of range [ 0, {len(self)} ]")
        label = np.array([self.labels[index]])
        datum = np.array([self.data_fn(index)])
        if self.n_sample == 1:
            return label, datum
        indexes = np.nonzero(self.labels == label)[0]
        indexes = self.rng.choice(indexes, self.n_sample - 1, replace=True)
        data = np.array([self.data_fn(i) for i in indexes])
        labels = np.repeat(label, self.n_sample)
        return labels, np.concatenate((datum, data), axis=0)


def triplet_batches(dataset: TripletDataset, batch_size: int,
                    shuffle: bool, rng=None
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (labels (B*n_sample,), data (B*n_sample, ...)) batches, matching
    the reference DataLoader + cat collation (run_training.py:593-598)."""
    if rng is None:
        rng = np.random
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    for i in range(0, len(order), batch_size):
        ids = order[i: i + batch_size]
        labels, data = zip(*(dataset[int(j)] for j in ids))
        yield np.concatenate(labels, 0), np.concatenate(data, 0)
