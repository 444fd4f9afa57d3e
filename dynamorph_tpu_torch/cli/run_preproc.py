"""Preprocess raw TIFFs into (T, 3, 1, Y, X) npy stacks (reference
run_preproc.py).

Usage: python -m dynamorph_tpu_torch.cli.run_preproc -c <config.yml>
       [--device cuda|cpu]

The stage runs on the host (TIFF reading, io/tiff.py); ``--device`` is
accepted like every CLI's, and like every entry point the CLI runs only
where its device is.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..config import load_config
from ..core.device import resolve_device
from ..pipeline.preprocess import discover_sites, run_preprocess
from .common import (config_parser, init_multihost_from_args, setup_logging,
                     shard_work)


def main(argv: Optional[Sequence[str]] = None) -> None:
    setup_logging()
    args = config_parser().parse_args(argv)
    init_multihost_from_args(args)
    resolve_device(args.device)
    config = load_config(args.config)
    pp = config.preprocess
    for src, target in zip(pp.image_dirs, pp.target_dirs):
        discovered = discover_sites(src, pp.fov, pp.pos_dir)
        mine = shard_work(sorted(discovered, key=str))
        run_preprocess(src, target, config,
                       sites={k: discovered[k] for k in mine})


if __name__ == "__main__":
    main()
