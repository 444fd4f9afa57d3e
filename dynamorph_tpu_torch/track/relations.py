"""Trajectory pair relations for the time-matching loss, the port
of ``dynamorph_tpu/track/relations.py``.

Behavioral spec: reference SingleCellPatch/generate_trajectories.py:441-515.
Relation codes: 2 = same trajectory, adjacent frames (and the diagonal);
1 = same trajectory, non-adjacent; absent/0 = unrelated.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..io.pickles import load_pickle


def patch_name_to_tuple(f: str, sites: Sequence[str]) -> Tuple[str, int, int]:
    """'.../<site>/<t>_<cell>.h5' -> (site, t, cell_id)
    (reference generate_trajectories.py:466-472)."""
    parts = [seg for seg in f.split("/") if len(seg) > 0]
    site_name = parts[-2]
    assert site_name in sites, f"site {site_name} not in {sites}"
    t_point = int(parts[-1].split("_")[0])
    cell_id = int(parts[-1].split("_")[1].split(".")[0])
    return (site_name, t_point, cell_id)


def generate_trajectory_relations(fs: List[str], sites: Sequence[str],
                                  well_supp_files_folder: str):
    """Build ((i, j) -> relation) dict + per-patch trajectory labels
    (reference generate_trajectories.py:441-515).

    Returns:
        relations (dict), labels (np.int32 array of len(fs))
    """
    assert len({s[:2] for s in sites}) == 1, "Sites should be from one well"

    patch_id_mapping = {patch_name_to_tuple(f, sites): i
                        for i, f in enumerate(fs)}
    labels = -1 * np.ones(len(fs), dtype=np.int32)
    relations: Dict[Tuple[int, int], int] = {
        (i, i): 2 for i in range(len(fs))}

    label_count = 0
    for site in sites:
        traj_path = os.path.join(well_supp_files_folder, site, "cell_traj.pkl")
        trajectories = load_pickle(traj_path)[0]
        for trajectory in trajectories:
            t_ids = sorted(trajectory.keys())
            patch_ids = []
            for t_idx in t_ids:
                key = (site, t_idx, trajectory[t_idx])
                assert key in patch_id_mapping, \
                    "Cannot find /%s/%d_%d" % key
                ref_id = patch_id_mapping[key]
                patch_ids.append(ref_id)
                labels[ref_id] = label_count
                if t_idx + 1 in t_ids:
                    adj_id = patch_id_mapping[(site, t_idx + 1,
                                               trajectory[t_idx + 1])]
                    relations[(ref_id, adj_id)] = 2
                    relations[(adj_id, ref_id)] = 2
            for i in patch_ids:
                for j in patch_ids:
                    if (i, j) not in relations:
                        relations[(i, j)] = 1
            label_count += 1

    orphans = labels == -1
    labels[orphans] = np.arange(label_count, label_count + orphans.sum())
    return relations, labels
