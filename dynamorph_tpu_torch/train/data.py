"""Host-side dataset utilities for VQ-VAE training (the port's own copy of
``dynamorph_tpu/train/data.py:20-192``).

Host-sequential preprocessing (graph walks, sparse slicing, splits) in
numpy: the same ``np.random.RandomState`` draws as the JAX package, so orders
and splits are identical. The device side lives in ``train/steps.py``.
"""
from __future__ import annotations

import collections
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.sparse import csr_matrix

from ..core.constants import CHANNEL_MAX
from ..io.pickles import load_pickle


def reorder_with_trajectories(dataset: np.ndarray, relations: Dict, seed=None):
    """Reorder samples so trajectories are contiguous (BFS over adjacent-frame
    relations), enabling trajectory-contiguous minibatches for the matching
    loss. Reference run_training.py:97-159.

    Returns (reordered dataset, csr relation matrix in new order, order index).
    """
    rng = np.random.RandomState(seed)
    n = len(dataset)
    adjacency = collections.defaultdict(list)
    for (i, j), v in relations.items():
        if v == 2:  # adjacent frames of the same trajectory
            adjacency[i].append(j)
    inds_pool = set(range(n))
    order: List[int] = []
    while inds_pool:
        start = int(rng.choice(sorted(inds_pool)))
        if start not in adjacency:
            order.append(start)
            inds_pool.remove(start)
            continue
        traj = [start]
        q = collections.deque([start])
        while q:
            elem = q.popleft()
            for e in adjacency[elem]:
                if e not in traj:
                    traj.append(e)
                    q.append(e)
        order.extend(traj)
        for e in traj:
            inds_pool.discard(e)
    order_arr = np.asarray(order)

    rows, cols, vals = [], [], []
    for (i, j), v in relations.items():
        if v in (1, 2):
            rows.append(i)
            cols.append(j)
            vals.append(v)
    rel = csr_matrix((np.asarray(vals), (np.asarray(rows), np.asarray(cols))),
                     shape=(n, n))
    rel = rel[order_arr][:, order_arr]
    return dataset[order_arr], rel, order


def concat_relations(relations: Sequence[Dict], labels: Sequence[np.ndarray],
                     offsets: Sequence[int]):
    """Merge per-well relation dicts with index offsets
    (reference run_training.py:299-321)."""
    new_relations: Dict = {}
    new_labels = []
    for relation, label, offset in zip(relations, labels, offsets):
        new_relations.update({
            (i + offset, j + offset): v for (i, j), v in relation.items()})
        new_labels.append(np.asarray(label) + offset)
    return new_relations, np.concatenate(new_labels, axis=0)


def train_val_split(dataset: np.ndarray, labels: np.ndarray,
                    val_split_ratio: float = 0.15, seed: int = 0):
    """Contiguous-window validation split (reference run_training.py:420-452):
    shuffle ids, then carve one contiguous window as val."""
    if not 0 < val_split_ratio < 1:
        raise ValueError(f"val_split_ratio {val_split_ratio} not in (0, 1)")
    n = len(dataset)
    rng = np.random.RandomState(seed)
    ids = np.arange(n)
    rng.shuffle(ids)
    split = int(np.floor(val_split_ratio * n))
    rng2 = np.random.RandomState(seed)
    split_start = rng2.randint(0, n - split)
    val_ids = ids[split_start: split_start + split]
    train_ids = np.concatenate([ids[:split_start], ids[split_start + split:]])
    return (dataset[train_ids], labels[train_ids],
            dataset[val_ids], labels[val_ids])


def split_data_ids(n: int, val_split_ratio: Optional[float], shuffle: bool,
                   rng):
    """The in-`train` split used when trajectory order must be preserved
    (reference run_training.py:487-497): val is a contiguous window of the
    (optionally shuffled) id range, train keeps order otherwise."""
    ids = list(range(n))
    if val_split_ratio is None:        # train on everything, no val split
        return ids, []
    split = int(np.floor(val_split_ratio * n))
    split_start = rng.randint(0, n - split)
    if shuffle:
        rng.shuffle(ids)
    val_ids = ids[split_start: split_start + split]
    train_ids = ids[:split_start] + ids[split_start + split:]
    return train_ids, val_ids


def slice_relation_mat(relation_mat, sample_ids) -> Optional[np.ndarray]:
    """Dense (B, B) relation block for a minibatch
    (reference run_training.py:335-355), as uint8: the values are exactly
    {0, 1, 2}, and at B = 768 the block is 4x fewer bytes to send than
    float32. The step casts it on the device."""
    if relation_mat is None:
        return None
    block = np.asarray(relation_mat[sample_ids][:, sample_ids].todense())
    return block.astype(np.uint8)


def slice_mask(mask: Optional[np.ndarray], sample_ids) -> Optional[np.ndarray]:
    """Batch weight masks: take the 'large' mask channel and map {-1,1}->{0,1}
    (reference run_training.py:358-374), as uint8 (binary); the step casts
    it on the device."""
    if mask is None:
        return None
    batch_mask = mask[sample_ids][:, 1:2, :, :]
    return ((batch_mask + 1.0) / 2.0).astype(np.uint8)


def zscore(input_image: np.ndarray, channel_mean=None, channel_std=None):
    """Dataset-level per-channel z-score (reference train_utils.py:228-250)."""
    if channel_mean is None:
        channel_mean = np.mean(input_image, axis=(0, 2, 3))
    if channel_std is None:
        channel_std = np.std(input_image, axis=(0, 2, 3))
    eps = np.finfo(float).eps
    mean = np.asarray(channel_mean).reshape(1, -1, 1, 1)
    std = np.asarray(channel_std).reshape(1, -1, 1, 1)
    return (input_image - mean) / (std + eps)


def zscore_patch(imgs: np.ndarray) -> np.ndarray:
    """Per-patch per-channel z-score (reference train_utils.py:252-274) —
    the inference-path normalisation used by process_VAE
    (pipeline/patch_VAE.py:418). The eps is float64's."""
    means = np.mean(imgs, axis=(2, 3), keepdims=True)
    stds = np.std(imgs, axis=(2, 3), keepdims=True)
    return (imgs - means) / (stds + np.finfo(float).eps)


DEFAULT_PREPROCESS_SETTING = {
    0: ("normalize", 0.4, 0.05),  # Phase
    1: ("scale", 0.05),           # Retardance
    2: ("normalize", 0.5, 0.05),  # Brightfield
}


def vae_preprocess(dataset: np.ndarray, use_channels=(0, 1),
                   preprocess_setting=None, clip=(0, 1)):
    """Scale raw uint16-range stacks into model input range
    (reference run_training.py:166-208)."""
    if preprocess_setting is None:
        preprocess_setting = DEFAULT_PREPROCESS_SETTING
    output = []
    for channel in use_channels:
        cs = dataset[:, channel] / CHANNEL_MAX
        setting = preprocess_setting[channel]
        if setting[0] == "scale":
            out = cs / cs.mean() * setting[1]
        elif setting[0] == "normalize":
            target_mean, target_sd = setting[1], setting[2]
            out = (cs - cs.mean()) / cs.std() * target_sd + target_mean
        else:
            raise ValueError(f"Preprocessing mode {setting[0]!r} not supported")
        if clip:
            out = np.clip(out, clip[0], clip[1])
        output.append(out)
    return np.stack(output, 1)


def unzscore(im_norm: np.ndarray, mean, std) -> np.ndarray:
    """Invert z-score normalisation (reference run_training.py:210-221) —
    needed before computing image-scale metrics such as SSIM on
    reconstructions."""
    return im_norm * (std + np.finfo(float).eps) + mean


def prepare_dataset_from_collection(fs: Sequence[str], cs=(0, 1),
                                    input_shape=(128, 128), file_path="./",
                                    file_suffix="_all_patches.pkl"):
    """Load patches from per-site ``<site>_all_patches.pkl`` collections
    (reference run_training.py:61-96; deprecated input format kept for
    compatibility with datasets assembled by older reference runs).

    ``fs`` are patch names of the form ``.../<site>/<patch_id>``; returns a
    float array (N, len(cs), *input_shape) in ``fs`` order.

    Each one-channel map is resized with ``pipeline.patch_vae._resize_chw``,
    the port's cv2 bilinear, in place of the JAX package's ``cv2.resize``:
    on one channel it equals cv2 bit for bit at integer factors, and within
    2.5e-6 of the largest magnitude at other sizes.
    """
    # imported here: pipeline.patch_vae imports this module
    from ..pipeline.patch_vae import _resize_chw

    tensors = {}
    sites = set(f.split("/")[-2] for f in fs)
    for site in sites:
        file_dat = load_pickle(os.path.join(file_path, f"{site}{file_suffix}"))
        for f_n in (f for f in fs if f.split("/")[-2] == site):
            dat = np.asarray(file_dat[f_n]["masked_mat"], dtype=float)
            dat = dat[np.arange(dat.shape[0]) if cs is None else np.array(cs)]
            # over the leading (channel, z) axes, as the reference's
            # cv2_fn_wrapper (extract_patches.py:21-37)
            flat = dat.reshape(-1, *dat.shape[-2:])
            resized = np.stack(
                [_resize_chw(m, tuple(input_shape)) for m in flat], 0)
            tensors[f_n] = resized.reshape(*dat.shape[:-2], *input_shape)
    return np.stack([tensors[key] for key in fs], 0)
