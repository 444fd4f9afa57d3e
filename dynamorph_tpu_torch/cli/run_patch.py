"""Patch extraction and trajectory building (reference run_patch.py).

Usage: python -m dynamorph_tpu_torch.cli.run_patch
       -m {extract_patches,build_trajectories} -c <config.yml>
       [--device cuda|cpu]

``extract_patches`` writes ``stacks_<t>.pkl`` per frame (the window, mask
and fill program on the device); ``build_trajectories`` writes
``cell_traj.pkl`` (LAP tracking on the host). Both read and write
``<supp>/<well>-supps/<site>/``.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..core.device import resolve_device
from ..pipeline.patch import build_trajectories, extract_patches
from .common import (parse_method_config, resolve_sites, segmented_sites,
                     setup_logging, shard_work)


def run_for_dirs(method: str, raw_dir: str, supp_dir: str, config,
                 device: str = "cuda") -> None:
    if method == "extract_patches" and not raw_dir:
        raise AttributeError(
            "raw directory must be specified when method = extract_patches")
    if not supp_dir:
        raise AttributeError(
            f"supplementary directory must be specified when method = "
            f"{method}")
    dev = resolve_device(device)
    sites = shard_work(
        segmented_sites(raw_dir, resolve_sites(raw_dir, config.patch.fov)))
    if method == "extract_patches":
        extract_patches(raw_dir, supp_dir, sites, config, device=dev)
    elif method == "build_trajectories":
        build_trajectories(raw_dir, supp_dir, sites, config)
    else:
        raise ValueError(f"unknown method {method!r}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    setup_logging()
    method, config, device = parse_method_config(
        choices=["extract_patches", "build_trajectories"], argv=argv)
    for raw_dir, supp_dir in zip(config.patch.raw_dirs,
                                 config.patch.supp_dirs):
        run_for_dirs(method, raw_dir, supp_dir, config, device=device)


if __name__ == "__main__":
    main()
