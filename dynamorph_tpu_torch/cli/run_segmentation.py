"""Semantic and instance segmentation (reference run_segmentation.py).

Usage: python -m dynamorph_tpu_torch.cli.run_segmentation
       -m {segmentation,instance_segmentation,segmentation_validation}
       -c <config.yml> [--device cuda|cpu]

``instance_segmentation`` clusters each site's ``_NNProbabilities.npy``
into cells on the host (DBSCAN); it writes ``cell_positions.pkl``,
``cell_pixel_assignments.pkl`` and ``segmentation_<t>.png`` into
``<supp>/<well>-supps/<site>/``. ``segmentation_validation`` draws the
cells' rims onto the raw frames, ``<supp>/validation_images/
<site>_predictions.tif`` (host work too).
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..core.device import resolve_device
from ..pipeline.patch import instance_segmentation
from ..pipeline.segmentation import segmentation, segmentation_validation
from .common import (parse_method_config, resolve_sites, setup_logging,
                     shard_work)

METHODS = ["segmentation", "instance_segmentation", "segmentation_validation"]


def main(argv: Optional[Sequence[str]] = None) -> None:
    setup_logging()
    method, config, device = parse_method_config(choices=METHODS, argv=argv)
    # the instance and validation stages run on the host, but like every
    # entry point the CLI runs only where its device is (no quiet drop to
    # the CPU)
    dev = resolve_device(device)
    si = config.segmentation_inference
    triples = zip(si.raw_dirs, si.supp_dirs,
                  si.validation_dirs or [None] * len(si.raw_dirs))
    for raw_dir, supp_dir, val_dir in triples:
        sites = shard_work(resolve_sites(raw_dir, si.fov))
        if method == "instance_segmentation":
            instance_segmentation(raw_dir, supp_dir, sites, config)
        elif method == "segmentation_validation":
            segmentation_validation(raw_dir, supp_dir, val_dir, sites,
                                    config)
        else:
            segmentation(raw_dir, supp_dir, val_dir, sites, config,
                         device=dev)


if __name__ == "__main__":
    main()
