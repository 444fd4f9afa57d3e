"""Shared CLI plumbing: the -m <method> -c <config> pattern (reference
run_*.py), ``--device``, and site discovery.

One process drives one card; wells and sites run in turn.
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional, Sequence

from ..config import load_config
from ..io.sites import get_im_sites


def setup_logging() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(levelname)4s: %(module)s:%(lineno)4s %(asctime)s] "
               "%(message)s")


def shard_work(items):
    """This process's slice of a share-nothing work list: all of it, since
    the port runs as one process."""
    return list(items)


def config_parser() -> argparse.ArgumentParser:
    """A parser of ``-c`` and ``--device``, the options every CLI takes."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True,
                        help="path to yaml configuration file")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="device to run on (default: cuda; without a "
                             "card the run fails unless --device cpu)")
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
