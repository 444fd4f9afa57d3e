"""Run the whole pipeline (or a span of stages) with one command.

Usage:
    python -m dynamorph_tpu_torch.cli.run_pipeline -c <config.yml> \
        [--stages segmentation instance_segmentation ...] [--no-resume] \
        [--device cuda|cpu]

Directories come from the ``patch`` section (raw_dirs/supp_dirs); stages
default to the full graph (see pipeline/orchestrator.py). ``--fused`` sets
``patch.fused``: the three front-end stages run as one device-resident
stage (pipeline/fused.py). ``--multihost`` (with ``--coordinator``,
``--num-processes`` and ``--process-id``, or under torchrun) shares the
wells over the ranks, one card a rank; the pooled PCA fit runs once, on
rank 0.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..config import load_config
from ..core.device import resolve_device
from ..pipeline.orchestrator import STAGES, run_pipeline
from .common import (config_parser, init_multihost_from_args, resolve_sites,
                     setup_logging)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, List[str]]:
    """Runs the stages over each raw directory; returns {raw_dir: the
    stages executed there}."""
    setup_logging()
    parser = config_parser()
    parser.add_argument("--stages", nargs="*", default=None,
                        choices=STAGES, help="subset of stages to run")
    parser.add_argument("--no-resume", action="store_true",
                        help="re-run stages even if outputs exist")
    parser.add_argument("--fused", action="store_true",
                        help="the fused seg -> instance -> patch front end "
                             "(overrides patch.fused)")
    args = parser.parse_args(argv)
    init_multihost_from_args(args)
    config = load_config(args.config)
    if args.fused:
        config.patch.fused = True
    dev = resolve_device(args.device)
    results = {}
    for raw_dir, supp_dir in zip(config.patch.raw_dirs,
                                 config.patch.supp_dirs):
        sites = resolve_sites(raw_dir, config.patch.fov)
        executed = run_pipeline(raw_dir, supp_dir, sites, config,
                                stages=args.stages,
                                resume=not args.no_resume, device=dev)
        print(f"{raw_dir}: executed stages {executed}")
        results[raw_dir] = executed
    return results


if __name__ == "__main__":
    main()
