"""Morphodynamic state clustering over latent trajectories.

Behavioral spec: reference HiddenStateExtractor/deprecated/
{morphology_clustering.py, movement_clustering.py} — k-means over short
trajectory windows of latent/PC descriptors (and their frame-to-frame
diffs) to discover discrete morphodynamic states, plus movement-magnitude
clustering (stagnant / minor-moving / moving). Cleaned, parameterised
equivalents of the reference's hard-coded scripts.

The port of ``dynamorph_tpu/analysis/state_clustering.py``: the windowing,
``trajectory_summaries`` and ``well_conditioned_gmm`` are its host numpy,
copied, so they equal the JAX package's bit for bit. The two k-means fits
run ``analysis/kmeans.py`` on the card in place of sklearn's ``KMeans``
(the same seeding scheme, Lloyd iterations and ``n_init=10``, but not
sklearn's random stream); they return its ``KMeansResult`` in place of the
fitted sklearn object.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from .kmeans import kmeans
from .trajectory_dynamics import generate_short_traj_collections


def short_traj_morphology(vs: np.ndarray, traj_list: Sequence[Sequence[int]],
                          length: int = 5) -> np.ndarray:
    """Sliding windows of per-patch descriptors along trajectories
    (reference morphology_clustering.py:103-113).

    Args:
        vs: (N, D) per-patch descriptor matrix (latents or PCs).
        traj_list: list of trajectories as patch-index lists.

    Returns (n_windows, length * D) array.
    """
    out = []
    for traj in traj_list:
        for i in range(len(traj) - length + 1):
            window = traj[i: i + length]
            out.append(np.concatenate([vs[j] for j in window]))
    return np.stack(out) if out else np.zeros((0, length * vs.shape[1]))


def kmeans_on_short_trajs(vs: np.ndarray,
                          traj_list: Sequence[Sequence[int]],
                          length: int = 5, n_clusters: int = 4,
                          diffs: bool = False, seed: int = 0,
                          device: Union[str, torch.device] = "cuda"):
    """K-means over short trajectory windows (reference
    morphology_clustering.py:115-141). With ``diffs``, cluster frame-to-frame
    descriptor changes instead of raw values.

    Returns (fitted KMeansResult, window features, window labels).
    """
    feats = short_traj_morphology(vs, traj_list, length=length)
    if diffs:
        d = vs.shape[1]
        feats = feats.reshape(len(feats), -1, d)
        feats = np.diff(feats, axis=1).reshape(len(feats), -1)
    km = kmeans(feats, n_clusters, seed=seed, device=device)
    return km, feats, km.labels_


def trajectory_summaries(traj_inds: Sequence[Sequence[int]],
                         traj_positions: Sequence[Dict],
                         pcs: np.ndarray, t_lag: int = 1,
                         um_per_pixel: float = 0.325,
                         hours_per_frame: float = 0.1518):
    """Per-trajectory feature rows [log mean speed, mean PC vector]
    (reference NOVEMBER_Analysis.ipynb 'GMM to multiple states' cell:
    per-trajectory mean PCs + log of mean t_lag-frame displacement scaled
    to um/h).

    Args:
        traj_inds: per trajectory, the patch indices into ``pcs``.
        traj_positions: per trajectory, {t: (y, x)} centroid dicts.
        pcs: (N, D) PCA-space descriptors.

    Returns (X, speeds): X is (n_traj, 1 + D); speeds the raw means.
    """
    rows, speeds = [], []
    for inds, pos in zip(traj_inds, traj_positions):
        t_keys = sorted(pos.keys())
        dists = [np.linalg.norm(np.asarray(pos[t + t_lag], np.float64) -
                                np.asarray(pos[t], np.float64))
                 for t in t_keys if (t + t_lag) in pos]
        mean_dist = float(np.mean(dists)) if dists else 0.0
        speeds.append(mean_dist)
        # mean_dist spans t_lag frames, so um/h needs t_lag*hours_per_frame
        # in the denominator (the reference notebook only ever uses
        # t_lag=1, where this reduces to its log(d*0.325/0.1518))
        log_speed = np.log(max(mean_dist, 1e-9) * um_per_pixel /
                           (t_lag * hours_per_frame))
        rows.append(np.concatenate([[log_speed],
                                    np.mean(pcs[np.asarray(inds)], axis=0)]))
    return np.stack(rows), np.asarray(speeds)


def well_conditioned_gmm(X: np.ndarray, y: np.ndarray,
                         init_centers: np.ndarray, n_iter: int = 50,
                         std_floor: float = 0.6, std_ceil: float = 10.0,
                         outlier_discount: float = 0.7,
                         outlier_power: float = 10.0,
                         min_std_ratio: float = 0.5):
    """Semi-supervised EM state assignment over trajectory features
    (reference NOVEMBER_Analysis.ipynb 'GMM' cell, parameterised).

    A GMM with per-component diagonal stds tied to a clipped global scale,
    per-well (condition) mixture priors learned alongside the components,
    and robust M-steps that down-weight samples far from their well median:
    weight = (1 - c*(d - d_min)/(d_max - d_min))^p.

    Args:
        X: (N, F) feature rows (trajectory_summaries output).
        y: (N,) integer condition/well labels (the prior grouping).
        init_centers: (K, F) initial component centers.

    Returns dict with 'posterior' (N, K), 'centers', 'stds',
    'well_prob_mat' (n_wells, K), and hard 'states' (N,).
    """
    X = np.asarray(X, np.float64)
    y = np.asarray(y)
    classes = sorted(np.unique(y).tolist())
    y_idx = np.searchsorted(np.asarray(classes), y)
    std_unit = np.clip(np.std(X, axis=0), std_floor, std_ceil)
    centers = [np.asarray(c, np.float64) for c in init_centers]
    stds = [std_unit.copy() for _ in centers]

    def sample_prob(X, centers, stds):
        d2 = np.square((X[:, None, :] - np.stack(centers)[None]) /
                       np.stack(stds)[None]).sum(2)
        d2 = d2 - d2.min(1, keepdims=True)
        return np.exp(-0.5 * d2)

    well_prob = np.zeros((len(classes), len(centers)))
    sp = sample_prob(X, centers, stds)
    for i in range(len(classes)):
        line = sp[y_idx == i].sum(0)
        well_prob[i] = line / line.sum()

    posterior = None
    for _ in range(n_iter):
        # E-step: sample likelihood x well prior
        sp = sample_prob(X, centers, stds)
        post = sp * well_prob[y_idx]
        post /= post.sum(1, keepdims=True)
        posterior = post
        # robust M-step: down-weight well-level outliers
        outlying = np.zeros(len(X))
        for i in range(len(classes)):
            inds = np.where(y_idx == i)[0]
            med = np.median(X[inds], axis=0, keepdims=True)
            outlying[inds] = np.linalg.norm(X[inds] - med, axis=1)
        rng_ = outlying.max() - outlying.min()
        if rng_ > 0:
            w_out = (1 - outlier_discount *
                     (outlying - outlying.min()) / rng_) ** outlier_power
        else:
            w_out = np.ones(len(X))
        weights = post * w_out[:, None]
        new_centers, new_stds = [], []
        for k in range(weights.shape[1]):
            w = weights[:, k:k + 1]
            center = (w * X).sum(0) / w.sum()
            std = np.sqrt((w * (X - center) ** 2).sum(0) / w.sum())
            # floor the scale ratio: without it a component that captures a
            # tight cluster sharpens, sheds members, and collapses to a
            # point (the reference notebook never hits this on its broad
            # real-data clusters; a library function must not NaN out)
            ratio = max(np.median((std / std_unit)[:min(5, X.shape[1])]),
                        min_std_ratio)
            new_centers.append(center)
            new_stds.append(ratio * std_unit)
        centers, stds = new_centers, new_stds
        well_prob = np.stack([
            weights[y_idx == i].sum(0) / weights[y_idx == i].sum()
            for i in range(len(classes))])
    return {"posterior": posterior, "centers": np.stack(centers),
            "stds": np.stack(stds), "well_prob_mat": well_prob,
            "states": np.argmax(posterior, axis=1)}


def movement_state_clustering(trajectories_positions: Sequence[Dict],
                              length: int = 5, n_clusters: int = 3,
                              seed: int = 0,
                              device: Union[str, torch.device] = "cuda"):
    """Cluster trajectories into movement states by displacement magnitude
    (reference movement_clustering.py:96-160: stagnant / minor_moving /
    moving by mean step displacement of k-means clusters).

    Returns {state_name: [trajectory indices]}.
    """
    windows = []
    owners = []
    for ti, traj in enumerate(trajectories_positions):
        segs = generate_short_traj_collections([traj], length=length)
        for s in segs:
            # per-step displacement magnitudes (log1p-compressed): movement
            # states are magnitude phenomena; clustering raw windows (as the
            # deprecated reference script did) mostly encodes direction
            steps = np.linalg.norm(np.diff(s, axis=0), axis=1)
            windows.append(np.log1p(np.sort(steps)))
        owners.extend([ti] * len(segs))
    if not windows:
        return {"stagnant": [], "minor_moving": [], "moving": []}
    windows = np.stack(windows)
    owners = np.asarray(owners)

    win_labels = kmeans(windows, n_clusters, seed=seed,
                        device=device).labels_
    # order clusters by mean displacement magnitude
    mags = []
    for c in range(n_clusters):
        mags.append(float(np.mean(windows[win_labels == c])))
    order = np.argsort(mags)
    base = ["stagnant", "minor_moving", "moving"]
    names = base[:n_clusters] if n_clusters <= len(base) else \
        base + [f"moving_{i + 2}" for i in range(n_clusters - len(base))]
    cluster_name = {int(order[i]): names[i] for i in range(n_clusters)}

    # assign each trajectory the majority state of its windows
    out: Dict[str, List[int]] = {n: [] for n in names}
    for ti in np.unique(owners):
        labs = win_labels[owners == ti]
        major = np.bincount(labs, minlength=n_clusters).argmax()
        out[cluster_name[int(major)]].append(int(ti))
    return out
