"""Site (field-of-view) discovery and naming conventions.

Conventions from the reference: sites are named like ``C5-Site_0``; the well
is the first two characters (reference pipeline/patch_VAE.py:148); site data
lives at ``<raw>/<site>.npy``.
"""
from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List


def get_im_sites(input_dir: str) -> List[str]:
    """FOV names from .npy files (reference extract_patches.py:337-350;
    excludes `_NN*` segmentation outputs)."""
    names = [f for f in os.listdir(input_dir)
             if f.endswith(".npy") and "_NN" not in f]
    return sorted({os.path.splitext(n)[0] for n in names})


def well_of(site: str) -> str:
    return site[:2]


def group_sites_by_well(sites: List[str]) -> Dict[str, List[str]]:
    wells = defaultdict(list)
    for s in sorted(sites):
        wells[well_of(s)].append(s)
    return dict(wells)


def site_supp_folder(supp_folder: str, site: str) -> str:
    """``<supp>/<well>-supps/<site>``: where a site's instance
    segmentation, patches and tracks live (reference
    pipeline/patch_VAE.py:48)."""
    return os.path.join(supp_folder, f"{well_of(site)}-supps", site)
