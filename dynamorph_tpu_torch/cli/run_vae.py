"""VAE dataset assembly, latent encoding and trajectory matching
(reference run_VAE.py).

Usage: python -m dynamorph_tpu_torch.cli.run_vae
       -m {assemble,process,trajectory_matching} -c <config.yml>
       [--device cuda|cpu]

``assemble`` and ``trajectory_matching`` are host steps over a well's
patches and tracks; ``process`` encodes on the device. Like the reference
(run_VAE.py:21) and the JAX package, ``assemble`` forces
patch_type='mat'; the config's patch_type applies elsewhere.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..core.device import resolve_device
from ..io.prefetch import AsyncWriter, Prefetcher
from ..io.sites import group_sites_by_well
from ..pipeline.patch_vae import (assemble_vae, load_well_inputs,
                                  process_vae, trajectory_matching)
from .common import (parse_method_config, resolve_sites, setup_logging,
                     shard_work)


def run_for_dirs(method: str, raw_dir: str, supp_dir: str, config,
                 device: str = "cuda") -> None:
    le = config.latent_encoding
    if method not in ("assemble", "process", "trajectory_matching"):
        raise ValueError(f"unknown method {method!r}")
    if method in ("assemble", "trajectory_matching") and not supp_dir:
        raise AttributeError(
            f"supplementary directory must be specified when method = "
            f"{method}")
    if method == "process" and not le.weights:
        raise AttributeError(
            "VQ-VAE weights path must be specified when method = process")
    dev = resolve_device(device)

    sites = resolve_sites(raw_dir, le.fov)
    all_wells = group_sites_by_well(sites)
    wells = {w: all_wells[w] for w in shard_work(sorted(all_wells))}
    if method == "assemble":
        for well_sites in wells.values():
            assemble_vae(raw_dir, supp_dir, well_sites, config,
                         patch_type="mat")
        return
    if method == "trajectory_matching":
        for well_sites in wells.values():
            trajectory_matching(raw_dir, supp_dir, well_sites)
        return
    # prefetch the next well's pickles while this one encodes, and drain
    # this well's latent pickle saves on a writer thread while the next
    # well encodes
    prefetched = Prefetcher(wells.items(),
                            lambda kv: load_well_inputs(raw_dir, kv[0]))
    with AsyncWriter(depth=2) as writer:
        for (well, well_sites), preloaded in prefetched:
            process_vae(raw_dir, supp_dir, well_sites, config,
                        preloaded=preloaded, writer=writer, device=dev)


def main(argv: Optional[Sequence[str]] = None) -> None:
    setup_logging()
    method, config, device = parse_method_config(
        choices=["assemble", "process", "trajectory_matching"], argv=argv)
    for raw_dir, supp_dir in zip(config.latent_encoding.raw_dirs,
                                 config.latent_encoding.supp_dirs):
        run_for_dirs(method, raw_dir, supp_dir, config, device=device)


if __name__ == "__main__":
    main()
