"""Shared CLI plumbing: the -m <method> -c <config> pattern (reference
run_*.py), ``--device``, the multi-process flags, and site discovery.

One process drives one card; wells and sites run in turn. With
``--multihost`` several processes join one process group
(``core.mesh.init_multihost``): the stage CLIs split their share-nothing
sites or wells over the ranks (``shard_work``), and ``run_training``
trains data-parallel, one card a rank.
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional, Sequence

from ..config import load_config
from ..core import mesh
from ..io.sites import get_im_sites


def setup_logging() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(levelname)4s: %(module)s:%(lineno)4s %(asctime)s] "
               "%(message)s")


def shard_work(items):
    """This process's slice of a share-nothing work list (all of it in one
    process), logged so the fan-out shows in the stage logs."""
    items = list(items)
    mine = mesh.process_slice(items)
    if mesh.is_multiprocess():
        logging.getLogger(__name__).info(
            "process %d/%d owns %d of %d work items", mesh.process_index(),
            mesh.process_count(), len(mine), len(items))
    return mine


def add_multihost_args(parser: argparse.ArgumentParser) -> None:
    """The multi-process flags of every CLI
    (dynamorph_tpu/cli/common.py:25-41)."""
    parser.add_argument("--multihost", action="store_true",
                        help="join a process group and share the work "
                             "over its ranks")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="rank 0's address host:port (omit under "
                             "torchrun, whose variables are read)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)


def init_multihost_from_args(args) -> None:
    """Join the process group when ``--multihost`` is given
    (``core.mesh.init_multihost``: the explicit trio goes together or not
    at all, and without it torchrun's variables are read). ``--device
    cpu`` takes gloo."""
    if args.multihost:
        mesh.init_multihost(
            args.coordinator, args.num_processes, args.process_id,
            backend="gloo" if args.device == "cpu" else None)


def config_parser() -> argparse.ArgumentParser:
    """A parser of ``-c``, ``--device`` and the multi-process flags, the
    options every CLI takes."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True,
                        help="path to yaml configuration file")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="device to run on (default: cuda; without a "
                             "card the run fails unless --device cpu)")
    add_multihost_args(parser)
    return parser


def parse_method_config(choices: Sequence[str],
                        argv: Optional[Sequence[str]] = None,
                        default: Optional[str] = None):
    """Parse ``-m``, ``-c`` and ``--device``; returns (method, config,
    device). ``-m`` is required unless a ``default`` is given
    (run_dim_reduction's is pca, as in the JAX package)."""
    parser = config_parser()
    parser.add_argument("-m", "--method", type=str, required=default is None,
                        choices=list(choices), default=default,
                        help=f"Method: one of {list(choices)}")
    args = parser.parse_args(argv)
    init_multihost_from_args(args)
    return args.method, load_config(args.config), args.device


def resolve_sites(raw_dir: str, fov) -> List[str]:
    if fov and fov != "all":
        # fov may be a single site NAME (schema allows str): don't split a
        # string into characters
        return [fov] if isinstance(fov, str) else list(fov)
    return get_im_sites(raw_dir)


def segmented_sites(raw_dir: str, sites: Sequence[str]) -> List[str]:
    """Sites that have both the raw stack and NN probability outputs
    (reference run_patch.py:55-60)."""
    out = [s for s in sites
           if os.path.exists(os.path.join(raw_dir, f"{s}.npy"))
           and os.path.exists(os.path.join(raw_dir,
                                           f"{s}_NNProbabilities.npy"))]
    if not out:
        raise AttributeError(
            "no sites found in raw directory with preprocessed data and "
            "matching NNProbabilities")
    return out
