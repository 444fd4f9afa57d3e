"""Semantic segmentation (reference run_segmentation.py).

Usage: python -m dynamorph_tpu_torch.cli.run_segmentation -m segmentation
       -c <config.yml> [--device cuda|cpu]

``instance_segmentation`` and ``segmentation_validation`` are not ported
yet and refuse with a message.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..pipeline.segmentation import segmentation
from .common import (parse_method_config, resolve_sites, setup_logging,
                     shard_work)

_NOT_PORTED = {
    "instance_segmentation": "ROADMAP slice C, instance segmentation and "
                             "tracking",
    "segmentation_validation": "ROADMAP slice C, segmentation_validation",
}


def main(argv: Optional[Sequence[str]] = None) -> None:
    setup_logging()
    method, config, device = parse_method_config(
        choices=["segmentation", *_NOT_PORTED], argv=argv)
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"run_segmentation -m {method} is not ported yet (comes with "
            f"{_NOT_PORTED[method]}); use dynamorph_tpu.cli.run_segmentation "
            "for it")
    si = config.segmentation_inference
    triples = zip(si.raw_dirs, si.supp_dirs,
                  si.validation_dirs or [None] * len(si.raw_dirs))
    for raw_dir, supp_dir, val_dir in triples:
        sites = shard_work(resolve_sites(raw_dir, si.fov))
        segmentation(raw_dir, supp_dir, val_dir, sites, config,
                     device=device)


if __name__ == "__main__":
    main()
