"""Preprocessing stage: raw TIFFs -> (T, 3, 1, Y, X) float npy stacks.

Behavioral spec: reference pipeline/preprocess.py:29-211 and run_preproc.py:
37-93. Channel order in the composite array is fixed: 0=Phase, 1=Retardance,
2=Brightfield. Host-side IO — nothing here needs the device. The port of
``dynamorph_tpu/pipeline/preprocess.py``; TIFFs are read by io/tiff.py, with
cv2's pixels and dtypes.
"""
from __future__ import annotations

import fnmatch
import logging
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..io.images import read_image, read_multipage_tiff

log = logging.getLogger(__name__)

_CHANNEL_SLOTS = ("Phase", "Retardance", "Brightfield")


def load_raw(fullpaths: Sequence[str], chans: Sequence[str],
             z_slice: Optional[int] = None, multipage: bool = True) -> np.ndarray:
    """Load one site's TIFFs into a (T, 3, 1, Y, X) composite array
    (reference pipeline/preprocess.py:29-141)."""
    loaded: Dict[str, np.ndarray] = {}
    for chan in chans:
        slot = next((s for s in _CHANNEL_SLOTS if s in chan), None)
        if slot is None:
            log.warning("not implemented: %s parse", chan)
            continue
        if multipage:
            files = sorted(c for c in fullpaths
                           if chan in os.path.basename(c)
                           and ".tif" in os.path.basename(c))
            if not files:
                log.warning("no files with %s identified", chan)
                continue
            if len(files) > 1:
                log.warning("duplicate matches for channel %s, skipping", chan)
                continue
            loaded[slot] = read_multipage_tiff(files[0])
        else:
            # single-page tiffs: time series with z### in the filename
            files = sorted(
                c for c in fullpaths
                if chan in os.path.basename(c)
                and f"z{z_slice:03d}" in os.path.basename(c))
            if not files:
                log.warning("no files with %s identified", chan)
                continue
            loaded[slot] = np.stack([read_image(f) for f in files])

    if not loaded:
        raise IOError("No channels could be loaded")
    shapes = [v.shape for v in loaded.values()]
    if shapes.count(shapes[0]) != len(shapes):
        raise ValueError(f"channel stacks disagree in shape: {shapes}")

    n_frame, y_size, x_size = shapes[0][:3]
    out = np.zeros((n_frame, 3, 1, y_size, x_size))
    for i, slot in enumerate(_CHANNEL_SLOTS):
        if slot in loaded:
            out[:, i, 0] = loaded[slot]
    return out


def report_range(arr: np.ndarray) -> np.ndarray:
    """Log per-channel mean/std (reference `adjust_range`,
    preprocess.py:144-173 — report only, z-scoring happens downstream)."""
    for i, name in enumerate(_CHANNEL_SLOTS):
        log.info("\t%s: %d plus/minus %d", name,
                 arr[:, i, 0].mean(), arr[:, i, 0].std())
    return arr


def write_raw_to_npy(site, site_list: Sequence[str], output: str,
                     chans: Sequence[str], z_slice: Optional[int],
                     multipage: bool = True) -> str:
    raw = report_range(load_raw(site_list, chans, z_slice, multipage))
    out_path = os.path.join(output, f"{site}.npy")
    os.makedirs(output, exist_ok=True)
    np.save(out_path, raw)
    log.info("saved image stack to %s", out_path)
    return out_path


def discover_sites(input_dir: str, fovs: Union[str, List],
                   pos_dir: bool) -> Dict[Union[str, int], List[str]]:
    """Map site -> list of image files (reference run_preproc.py:37-93).

    pos_dir=True: each position is a subdirectory. pos_dir=False: files named
    ``t###_p###_z###`` in one directory, positions parsed from ``p`` tokens.
    """
    sites: Dict[Union[str, int], List[str]] = {}
    if pos_dir:
        subdirs = [d for d in os.listdir(input_dir)
                   if os.path.isdir(os.path.join(input_dir, d))]
        if fovs != "all":
            if not isinstance(fovs, list):
                raise NotImplementedError(
                    "preprocess FOVs must be 'all' or a list of positions")
            subdirs = [d for d in subdirs if d in fovs]
        for d in sorted(subdirs):
            full = os.path.join(input_dir, d)
            sites[d] = [os.path.join(full, f) for f in sorted(os.listdir(full))]
    else:
        all_files = [f for f in os.listdir(input_dir)
                     if os.path.isfile(os.path.join(input_dir, f))
                     and "_p" in f and ".tif" in f]
        if fovs == "all":
            for f in sorted(all_files):
                pos_tokens = [int(tok.lstrip("p")) for tok in f.split("_")
                              if tok.startswith("p") and tok[1:].isdigit()]
                if not pos_tokens:
                    continue
                sites.setdefault(pos_tokens[0], []).append(
                    os.path.join(input_dir, f))
        elif isinstance(fovs, list):
            for fov in fovs:
                sites[fov] = [os.path.join(input_dir, f) for f in
                              sorted(fnmatch.filter(all_files, f"*p{fov:03d}*"))]
        else:
            raise NotImplementedError(
                "preprocess FOVs must be 'all' or a list of positions")
    return sites


def run_preprocess(input_dir: str, output_dir: str, config,
                   sites=None) -> List[str]:
    """Full preprocess stage for one experiment directory.

    ``sites``: optional subset to process — either a list of site names or
    an already-discovered ``{name: files}`` mapping (multi-host CLIs pass
    this process's slice of their own discovery — cli/run_preproc.py; the
    library default discovers and processes everything, so programmatic
    callers always get complete output).
    """
    pp = config.preprocess
    if isinstance(sites, dict):
        discovered = sites
        names = sorted(discovered, key=str)
    else:
        discovered = discover_sites(input_dir, pp.fov, pp.pos_dir)
        names = sorted(discovered, key=str)
        if sites is not None:
            wanted = set(sites)
            names = [s for s in names if s in wanted]
    outputs = []
    for site in names:
        outputs.append(write_raw_to_npy(
            site, discovered[site], output_dir, pp.channels, pp.z_slice,
            multipage=pp.multipage))
    return outputs
