"""Readings that a cell's limits for ``correct`` are set from, made in one
process a card: the program's read epoch on many seeds, then the plain
reference's epochs (each seed's, and on the control seeds the control and
the faults, each the reference put in the program's place), shared out
over the cards. See ``benchmarks/calibrate.py``.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from dynamorph_tpu_torch.core import mesh

from . import train

# each the reference put in the program's place: TF32 (the precision below
# the stated float32), and the faults
CONTROLS = ("tf32", "half_batch", "unchanged", "half_codebook")
CONTROLS_OVER_RANKS = CONTROLS + ("no_exchange",)


def reference_kw(kind: str) -> Dict:
    """``train.reference``'s keywords for a reading of ``kind``."""
    if kind == "exact":
        return {}
    if kind == "tf32":
        return {"tf32": True}
    return {"fault": kind}


def readings(cfg: Dict, traffic: Dict, seeds: Sequence[int],
             jobs: Sequence[Tuple[int, str]], out_dir: str,
             device: Optional[str] = None) -> Dict:
    """On this process's card: the program's read epoch on each of
    ``seeds`` (over ranks, every rank takes part), then this rank's share
    of ``jobs``, each (seed, kind) a reference epoch. Returns {"program":
    {seed: readings}, "reference": [(seed, kind, readings)]}."""
    dev = torch.device(device) if device else mesh.rank_device() or \
        torch.device("cuda", 0)
    distributed = mesh.is_distributed()
    ranks = mesh.process_count() if distributed else 1
    rank = mesh.process_index() if distributed else 0
    program = {}
    for s in seeds:
        inp = train.Inputs(cfg, traffic, s, dev)
        model = train.program_model(cfg, inp.weights, dev)
        program[s] = train.read_epoch(model, inp, cfg, ranks, s, out_dir,
                                      dev)
        del model, inp
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    mesh.barrier("references")
    refs: List = []
    for i, (s, kind) in enumerate(jobs):
        if i % ranks == rank:
            t = time.perf_counter()
            refs.append((s, kind, train.reference(cfg, traffic, s, ranks,
                                                  dev, **reference_kw(kind))))
            print(f"reference {kind} seed {s} on {dev}: "
                  f"{time.perf_counter() - t:.3f} s", file=sys.stderr,
                  flush=True)
    return {"program": program, "reference": refs}
