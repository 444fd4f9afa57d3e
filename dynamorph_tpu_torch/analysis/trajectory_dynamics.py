"""Trajectory movement analysis: mean-squared-displacement (MSD) curves —
the port's own copy of ``dynamorph_tpu/analysis/trajectory_dynamics.py``
(host numpy, so its results equal the JAX package's bit for bit).

Behavioral spec: reference HiddenStateExtractor/deprecated/
movement_clustering.py:20-50 — per-lag squared displacement distributions,
MSD curve, and log-log power-law fit (anomalous diffusion exponent). The
reference version is deprecated/hard-coded; this is the cleaned equivalent.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def generate_msd_distri(trajectories_positions: Sequence[Dict],
                        max_lag: int = 14) -> Dict[int, List[float]]:
    """Per-lag squared-displacement samples over all trajectories
    (reference movement_clustering.py:20-28)."""
    msd: Dict[int, List[float]] = {i: [] for i in range(1, max_lag + 1)}
    for traj in trajectories_positions:
        t_keys = sorted(traj.keys())
        for i, t1 in enumerate(t_keys):
            for t2 in t_keys[i + 1:]:
                lag = t2 - t1
                if lag in msd:
                    d = np.linalg.norm(
                        np.asarray(traj[t2], float) -
                        np.asarray(traj[t1], float))
                    msd[lag].append(float(d ** 2))
    return msd


def msd_curve(trajectories_positions: Sequence[Dict],
              max_lag: int = 14) -> np.ndarray:
    """(lag, mean squared displacement) points."""
    msd = generate_msd_distri(trajectories_positions, max_lag)
    ks = sorted(k for k in msd if msd[k])
    # (0, 2)-shaped when no lag has samples, so callers can index columns
    return np.array([(k, np.mean(msd[k])) for k in ks]).reshape(-1, 2)


def fit_msd_powerlaw(points: np.ndarray, first_n_points: int = 5,
                     with_intercept: bool = False) -> Tuple[float, float]:
    """Fit MSD ~ D * lag^alpha on the first n points (log-log linear fit).
    Returns (alpha, D). alpha ~ 1 = diffusive, > 1 superdiffusive."""
    pts = points[:first_n_points]
    x = np.log(pts[:, 0])
    y = np.log(pts[:, 1])
    if with_intercept:
        A = np.stack([x, np.ones_like(x)], 1)
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        alpha, log_d = coef
    else:
        # force through the lag-1 point: y - y0 = alpha (x - x0)
        alpha = float(np.sum((x - x[0]) * (y - y[0])) /
                      max(np.sum((x - x[0]) ** 2), 1e-12))
        log_d = y[0] - alpha * x[0]
    return float(alpha), float(np.exp(log_d))


def plot_msd(trajectories_positions: Sequence[Dict], path: str,
             fit: bool = True, first_n_points: int = 5) -> np.ndarray:
    """Save an MSD curve plot (reference movement_clustering.py:30-50)."""
    import matplotlib

    matplotlib.use("AGG")
    import matplotlib.pyplot as plt

    points = msd_curve(trajectories_positions)
    plt.clf()
    plt.plot(points[:, 0], points[:, 1], ".-", label="MSD")
    if fit and len(points) >= 2:
        alpha, d = fit_msd_powerlaw(points, first_n_points)
        xs = points[:, 0]
        plt.plot(xs, d * xs ** alpha, "--",
                 label=f"fit: alpha={alpha:.2f}")
    plt.xlabel("lag (frames)")
    plt.ylabel("MSD (px^2)")
    plt.legend()
    plt.savefig(path, dpi=200, bbox_inches="tight")
    plt.close()
    return points


def generate_short_traj_collections(trajectories_positions: Sequence[Dict],
                                    length: int = 5, raw: bool = False):
    """Sliding fixed-length windows of trajectories
    (reference movement_clustering.py:52-71)."""
    out = []
    for traj in trajectories_positions:
        t_keys = sorted(traj.keys())
        for i in range(len(t_keys) - length + 1):
            window = t_keys[i: i + length]
            if window[-1] - window[0] != length - 1:
                continue  # require consecutive frames
            seg = [np.asarray(traj[t], float) for t in window]
            if raw:
                out.append(seg)
            else:
                seg = np.stack(seg)
                out.append(seg - seg[0])  # origin-normalised
    return out
