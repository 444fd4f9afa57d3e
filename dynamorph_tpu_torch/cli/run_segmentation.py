"""Semantic and instance segmentation (reference run_segmentation.py).

Usage: python -m dynamorph_tpu_torch.cli.run_segmentation
       -m {segmentation,instance_segmentation} -c <config.yml>
       [--device cuda|cpu]

``instance_segmentation`` clusters each site's ``_NNProbabilities.npy``
into cells on the host (DBSCAN); it writes ``cell_positions.pkl``,
``cell_pixel_assignments.pkl`` and ``segmentation_<t>.png`` into
``<supp>/<well>-supps/<site>/``. ``segmentation_validation`` is not ported
yet and refuses with a message.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..core.device import resolve_device
from ..pipeline.patch import instance_segmentation
from ..pipeline.segmentation import segmentation
from .common import (parse_method_config, resolve_sites, setup_logging,
                     shard_work)

_NOT_PORTED = {
    "segmentation_validation": "ROADMAP slice C, segmentation_validation",
}


def main(argv: Optional[Sequence[str]] = None) -> None:
    setup_logging()
    method, config, device = parse_method_config(
        choices=["segmentation", "instance_segmentation", *_NOT_PORTED],
        argv=argv)
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"run_segmentation -m {method} is not ported yet (comes with "
            f"{_NOT_PORTED[method]}); use dynamorph_tpu.cli.run_segmentation "
            "for it")
    # the instance stage runs on the host, but like every entry point the
    # CLI runs only where its device is (no quiet drop to the CPU)
    dev = resolve_device(device)
    si = config.segmentation_inference
    triples = zip(si.raw_dirs, si.supp_dirs,
                  si.validation_dirs or [None] * len(si.raw_dirs))
    for raw_dir, supp_dir, val_dir in triples:
        sites = shard_work(resolve_sites(raw_dir, si.fov))
        if method == "instance_segmentation":
            instance_segmentation(raw_dir, supp_dir, sites, config)
        else:
            segmentation(raw_dir, supp_dir, val_dir, sites, config,
                         device=dev)


if __name__ == "__main__":
    main()
