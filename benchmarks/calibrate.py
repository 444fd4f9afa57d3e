"""Readings that a cell's limits for ``correct`` are set from (see
PERF.md): the program's gaps on many seeds (its read epoch, as a run of the
cell makes it in set-up), and on a few more seeds the control and the
faults, each the reference put in the program's place:

- ``tf32``: the reference with TF32 on (the precision below the stated
  float32);
- ``half_batch``: every step on the first half of its batch;
- ``unchanged``: every step leaves the parameters and the running
  batch-norm statistics as they were;
- ``half_codebook``: validation searches the first half of the codebook
  alone;
- ``no_exchange`` (cells over several ranks): rank 0's chunk alone.

    python3 benchmarks/calibrate.py --workload <name> --seeds 1,2,3 \\
        --control-seeds 7,8,9

Runs in one process a card the cell asks for (over ranks, one launch for
every seed), and shares the reference's epochs out over the cards. One
line ``CAL {json}`` per reading, and a summary: the largest program gap
and the smallest of each control or fault.
"""
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import argparse  # noqa: E402
from pathlib import Path  # noqa: E402

from dynamorph_tpu_torch.core import mesh  # noqa: E402
from yardstick import calib, correct  # noqa: E402
from yardstick.spec import Spec  # noqa: E402


def calibrate(spec: Spec, workload: str, seeds, control_seeds,
              device: str = "cuda", out=print) -> dict:
    """The readings of ``workload``: {kind: {number: [values]}}."""
    cell = spec.cell(workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    ranks = traffic["ranks"]
    controls = calib.CONTROLS_OVER_RANKS if ranks > 1 else calib.CONTROLS
    jobs = [(s, "exact") for s in list(seeds) + list(control_seeds)] + \
        [(s, k) for s in control_seeds for k in controls]
    out_dir = tempfile.mkdtemp(prefix="bench_calibrate_")
    try:
        args = (cfg, traffic, list(seeds), jobs, out_dir)
        if ranks == 1:
            got = [calib.readings(*args, device=f"{device}:0"
                                  if device == "cuda" else device)]
        else:
            devices = [f"cuda:{r}" for r in range(ranks)] \
                if device == "cuda" else [device] * ranks
            got = mesh.run_local_ranks(calib.readings, args, devices)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    refs = {(s, k): r for g in got for s, k, r in g["reference"]}
    seen = {}

    def record(kind, seed, prog):
        gaps, where = correct.gaps(prog, refs[(seed, "exact")])
        out("CAL " + json.dumps({"kind": kind, "seed": seed, "gaps": gaps,
                                 "where": where}))
        for k, v in gaps.items():
            seen.setdefault(kind, {}).setdefault(k, []).append(v)

    for s in seeds:
        record("program", s, got[0]["program"][s])
    for s in control_seeds:
        for k in controls:
            record(k, s, refs[(s, k)])
    for kind, nums in seen.items():
        agg = max if kind == "program" else min
        out(f"SUMMARY {kind} " + json.dumps(
            {k: [agg(v), len(v)] for k, v in nums.items()}))
    return seen


def main():
    p = argparse.ArgumentParser(description="Readings for the limits of "
                                "a cell's comparison.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    args = p.parse_args()
    t = time.perf_counter()
    calibrate(Spec(Path(HERE).parent), args.workload,
              [int(x) for x in args.seeds.split(",") if x],
              [int(x) for x in args.control_seeds.split(",") if x],
              out=lambda line: print(line, flush=True))
    print(f"calibrated in {time.perf_counter() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main()
