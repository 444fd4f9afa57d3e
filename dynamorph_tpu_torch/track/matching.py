"""Frame-to-frame cell matching and trajectory assembly (LAP tracking),
the port of ``dynamorph_tpu/track/matching.py``.

Behavioral spec: reference SingleCellPatch/generate_trajectories.py —
`frame_matching` :23-70 (distance^2 x size-ratio cost with 100 px cutoff and
1.05*cutoff^2 no-match diagonal), `trajectory_connection` :96-288 (gap-closing
LAP following Jaqaman et al., nmeth.1237; gaps of 2-3 frames), and
`generate_trajectories` :291-323 (greedy chain link + gap LAP + min length).

These are host-sequential solver calls on small matrices (n_cells per frame
is O(100)), as in the JAX package.
"""
from __future__ import annotations

import warnings
from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment
from scipy.spatial.distance import cdist

from ..native import NativeError


# From this size up, finite square instances go to the native JV solver
# (native/lap.cpp). Below it, and for non-finite costs (which JV refuses),
# scipy: on small matrices with ties (the no-match plateaus) scipy's
# Hungarian picks the optimum the reference picked, which keeps the tracks
# identical; on large ones the optimum is unique almost surely. This is the
# tie-break rule of the JAX package (track/matching.py:31-40).
NATIVE_LAP_MIN_N = 256


def solve_lap(cost_mat: np.ndarray):
    """Linear assignment: scipy for small or non-finite instances, the
    native Jonker-Volgenant solver for large ones."""
    n = cost_mat.shape[0]
    if n >= NATIVE_LAP_MIN_N and cost_mat.shape[0] == cost_mat.shape[1] \
            and np.isfinite(cost_mat).all():
        from ..native.lap import lap_solve

        return lap_solve(cost_mat)
    return linear_sum_assignment(cost_mat)


def frame_matching(f1, f2, int1, int2, dist_cutoff: int = 100,
                   int_eff: float = 1.4):
    """LAP matching of cells between two frames
    (reference generate_trajectories.py:23-70).

    Returns (pairs, top-5 highest-cost pairs dict).
    """
    f1 = np.array(f1).reshape((-1, 2))
    f2 = np.array(f2).reshape((-1, 2))
    int1 = np.array(int1).reshape((-1, 1)).astype(float)
    int2 = np.array(int2).reshape((-1, 1)).astype(float)

    int_dist_mat = int2.reshape((1, -1)) / int1.reshape((-1, 1))
    int_dist_mat = int_dist_mat + 1.0 / int_dist_mat
    int_dist_mat[int_dist_mat >= 2.5] = 20.0
    int_dist_mat = int_dist_mat ** int_eff
    int_dist_baseline = np.percentile(int_dist_mat, 10)

    n1, n2 = len(f1), len(f2)
    big = dist_cutoff ** 2 * 10
    cost_mat = np.ones((n1 + n2, n1 + n2)) * big * int_dist_baseline
    dist_mat = cdist(f1, f2) ** 2
    dist_mat[dist_mat >= dist_cutoff ** 2] = big
    cost_mat[:n1, :n2] = dist_mat * int_dist_mat

    no_match = 1.05 * (dist_cutoff ** 2) * int_dist_baseline
    for i in range(n1):
        cost_mat[i, i + n2] = no_match
    for j in range(n2):
        cost_mat[n1 + j, j] = no_match
    cost_mat[n1:, n2:] = dist_mat.T

    links = solve_lap(cost_mat)
    pairs, costs = [], []
    for pair in zip(*links):
        if pair[0] < n1 and pair[1] < n2:
            pairs.append(pair)
            costs.append(cost_mat[pair[0], pair[1]])
    top = {pairs[i]: costs[i] for i in np.argsort(costs)[-5:]}
    return pairs, top


def trajectory_connection(trajectories: List[Dict], trajectories_positions,
                          dist_cutoff: float = 100):
    """Gap-closing LAP over whole trajectories
    (reference generate_trajectories.py:96-288, gap-only path; merge/split
    scaffolding in the reference is unfinished and not reproduced).
    """
    starts = [min(t.keys()) for t in trajectories_positions]
    ends = [max(t.keys()) for t in trajectories_positions]
    n = len(trajectories_positions)
    big = dist_cutoff ** 2 * 10

    upper_left = np.ones((n, n)) * big
    pos_x = [trajectories_positions[i][e] for i, e in enumerate(ends)]
    pos_y = [trajectories_positions[j][s] for j, s in enumerate(starts)]
    dist_mat = cdist(pos_x, pos_y) ** 2
    gap = np.array(starts).reshape((1, -1)) - np.array(ends).reshape((-1, 1))
    # gaps of exactly 2 frames cost 1x, 3 frames cost 4x
    mask_mat = (gap == 2) * 1 + (gap == 3) * 4
    mask_mat[dist_mat >= dist_cutoff ** 2] = 0
    upper_left = mask_mat * dist_mat + (1 - np.sign(mask_mat)) * upper_left

    valid = upper_left[upper_left < np.max(upper_left)]
    if len(valid) > 0:
        diag = np.percentile(valid, 90)
    else:
        diag = np.max(upper_left) * 0.9

    upper_right = np.ones((n, n)) * big
    np.fill_diagonal(upper_right, diag)
    lower_left = np.ones((n, n)) * big
    np.fill_diagonal(lower_left, diag)
    lower_right = upper_left.T

    cost_mat = np.block([[upper_left, upper_right],
                         [lower_left, lower_right]])
    links = solve_lap(cost_mat)

    connection_maps = {}
    for a, b in zip(*links):
        if a < n and b < n:
            assert b > a
            connection_maps[a] = b

    connected, involved = [], set()
    for i in range(len(trajectories)):
        if i in involved:
            continue
        con = [i]
        involved.add(i)
        while i in connection_maps:
            con.append(connection_maps[i])
            involved.add(connection_maps[i])
            i = connection_maps[i]
        connected.append(con)

    new_trajectories = []
    for con in connected:
        t = dict(trajectories[con[0]])
        for c in con[1:]:
            t.update(trajectories[c])
        new_trajectories.append(t)
    return new_trajectories


def generate_trajectories(matchings: Dict, positions_dict: Dict,
                          min_length: int = 10):
    """Link per-frame matchings into trajectories, close gaps, filter short
    (reference generate_trajectories.py:291-323)."""
    trajectories: List[Dict] = []
    for t_point in sorted(matchings.keys()):
        for pair in matchings[t_point]:
            for t in trajectories:
                if t_point in t and t[t_point] == pair[0]:
                    t[t_point + 1] = pair[1]
                    break
            else:
                trajectories.append({t_point: pair[0], t_point + 1: pair[1]})
    trajectories_positions = [
        {tp: positions_dict[tp][t[tp]] for tp in t} for t in trajectories]
    trajectories = trajectory_connection(
        trajectories, trajectories_positions, dist_cutoff=100.0)
    trajectories = [t for t in trajectories if len(t) > min_length]
    trajectories_positions = [
        {tp: positions_dict[tp][t[tp]] for tp in t} for t in trajectories]
    return trajectories, trajectories_positions


def build_site_trajectories(cell_positions: Dict, cell_pixel_assignments: Dict,
                            min_length: int = 10):
    """Full per-site tracking from instance-segmentation outputs
    (reference process_site_build_trajectory, generate_trajectories.py:
    372-438). Returns (trajectories, trajectory_positions)."""
    cell_matchings = {}
    try:
        # the reference asserts outside its try and crashes on gappy inputs
        # (generate_trajectories.py:396); here bad inputs degrade to empty
        # trajectories with a warning like other tracking failures
        t_points = sorted(cell_positions.keys())
        assert np.allclose(np.array(t_points)[1:] - 1,
                           np.array(t_points)[:-1]), \
            "timepoints must be consecutive"

        cell_positions_dict = {k: dict(cell_positions[k])
                               for k in cell_positions}
        cell_size_dict = {}
        for t_point in t_points:
            _, positions_labels = cell_pixel_assignments[t_point]
            all_cells = cell_positions[t_point]
            counts = dict(zip(*np.unique(positions_labels,
                                         return_counts=True)))
            cell_size_dict[t_point] = {cid: counts[cid]
                                       for cid, _ in all_cells}

        for t_point in t_points[:-1]:
            ids1 = sorted(cell_positions_dict[t_point].keys())
            ids2 = sorted(cell_positions_dict[t_point + 1].keys())
            if len(ids1) == 0 or len(ids2) == 0:
                # CONSCIOUS deviation: an empty frame yields no matchings
                # and tracking continues. The reference calls frame_matching
                # unconditionally, which throws on empty inputs
                # (np.percentile of an empty distance matrix,
                # generate_trajectories.py:423) and degrades the WHOLE site
                # to empty trajectories via the caller's except
                # (:431-433) — losing every other frame's tracks to one
                # blank frame.
                cell_matchings[t_point] = []
                continue
            f1 = [cell_positions_dict[t_point][i] for i in ids1]
            f2 = [cell_positions_dict[t_point + 1][i] for i in ids2]
            int1 = [cell_size_dict[t_point][i] for i in ids1]
            int2 = [cell_size_dict[t_point + 1][i] for i in ids2]
            pairs, _ = frame_matching(f1, f2, int1, int2, dist_cutoff=100)
            cell_matchings[t_point] = [(ids1[p1], ids2[p2]) for p1, p2 in pairs]
        return generate_trajectories(cell_matchings, cell_positions_dict,
                                     min_length=min_length)
    except NativeError:
        raise  # a broken native library is not a degenerate site
    except Exception as e:  # degrade like the reference (:431-433)
        warnings.warn(f"No trajectory is generated due to: {e}")
        return [], []
