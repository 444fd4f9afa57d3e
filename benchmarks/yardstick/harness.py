"""One run of one cell: the program's session(s), the reference, the
comparison, the metrics and the result line.

The result line is the last line of standard output, one JSON object:
``correct``, ``attempted`` and ``failed`` (epochs in the window, and those
whose training loss is not finite), ``metrics``, ``device``, with
``--trace 1`` a ``breakdown``, and last ``compared``: each number the
comparison judged, beside its limit. The same numbers are the last lines
of standard error.

A run prints no result, and exits with 3, when a module that a run may not
load (``train.FORBIDDEN``) is loaded once the window has closed: in this
process, or in any local rank, each of which looks in its own.
"""
from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from dynamorph_tpu_torch.core import mesh

from . import correct, train
from .spec import Spec
from .train import forbidden_modules


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Context:
    """What a metric's reader reads: the run's timings and, when traced,
    each process's trace summary (``trace.summarize``), rank 0 first."""
    cfg: Dict
    traffic: Dict
    chips: int
    ranks: int
    setup_s: float
    window_s: float
    epochs: int
    train_batches: List[int]
    val_batches: List[int]
    traces: Optional[List[Dict]] = None


def run_cell(spec: Spec, workload: str, seed: int, seconds: float,
             trace: bool, t0: float, device: str = "cuda",
             session=None) -> Dict:
    """Runs the cell and returns {"correct", "attempted", "failed",
    "metrics", "device", "breakdown", "compared", "gaps", "where",
    "forbidden"}; "forbidden" names the modules that a run may not load
    that any session found loaded after its window.
    ``session`` replaces ``train.session`` (the tests plant faults with
    it; over ranks it must be importable by name)."""
    cell = spec.cell(workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(workload)
    ranks = traffic["ranks"]
    on_card = device == "cuda"
    session = train.session if session is None else session
    out_dir = tempfile.mkdtemp(prefix="bench_train_")
    try:
        if ranks == 1:
            sessions = [session(cfg, traffic, seed, seconds, trace, t0,
                                      out_dir, f"{device}:0" if on_card
                                      else device)]
        else:
            devices = [f"cuda:{r}" for r in range(ranks)] if on_card \
                else ["cpu"] * ranks
            sessions = mesh.run_local_ranks(
                session, (cfg, traffic, seed, seconds, trace, t0,
                                out_dir), devices)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    first = sessions[0]
    log(f"set-up {first['setup_s']:.3f} s, warm epoch {first['warm_s']:.3f}"
        f" s, window {first['window_s']:.3f} s over {first['epochs']} "
        f"epochs; set-up parts " + ", ".join(
            f"{k} {v:.3f} s" for k, v in first["setup_parts"].items()))
    gc.collect()

    # the reference, once the program's state is freed
    t = time.perf_counter()
    dev = torch.device(device, 0) if on_card else torch.device(device)
    if on_card:
        # over ranks this process has not touched the card yet
        torch.empty(0, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
    expected = train.reference(cfg, traffic, seed, ranks, dev)
    log(f"reference: {time.perf_counter() - t:.3f} s, peak " + (
        f"{torch.cuda.max_memory_allocated(dev)} bytes" if on_card
        else "not read"))
    values, where = correct.gaps(first["readings"], expected)
    ok, compared = correct.judge(values, limits)

    n = traffic["patches"]
    train_b, val_b = train.epoch_batches(n, cfg, ranks)
    traces = [s["trace"] for s in sessions] if trace else None
    ctx = Context(cfg, traffic, cell["chips"], ranks,
                  first["setup_s"], first["window_s"], first["epochs"],
                  train_b, val_b, traces)
    wanted = spec.per_layer(workload) if trace else \
        spec.end_to_end(workload)
    metrics = {}
    for m in wanted:
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if on_card else device,
        "kind": torch.cuda.get_device_name(0) if on_card else device,
        "count": cell["chips"],
        "memory_peak_bytes": max(s["memory_peak_bytes"] for s in sessions)}
    breakdown = None
    if trace:
        summaries = [s for s in traces if s is not None]
        if summaries:
            device_info["busy_s"] = float(np.mean([s["busy_s"]
                                                   for s in summaries]))
            device_info["window_s"] = summaries[0]["window_s"]
            from .trace import top_kernels
            breakdown = {"device_ops": top_kernels(summaries[0]),
                         "idle_gaps": summaries[0]["gaps"]}
    return {"correct": bool(ok), "attempted": first["epochs"],
            "failed": first["failed"], "metrics": metrics,
            "device": device_info, "breakdown": breakdown,
            "compared": compared, "gaps": values, "where": where,
            "forbidden": sorted({m for s in sessions
                                 for m in s["forbidden"]})}


def report(res: Dict) -> int:
    """Prints the run's result line, or refuses it (3, no line) where a
    module that a run may not load was loaded in this process or in a
    session's."""
    found = sorted(set(res["forbidden"]) | set(forbidden_modules()))
    if found:
        log(f"modules that may not be loaded are loaded: {found}")
        return 3
    for k, v in res["where"].items():
        log(f"widest {k} at {v}")
    line = {k: res[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device")}
    if res["breakdown"] is not None:
        line["breakdown"] = res["breakdown"]
    line["compared"] = res["compared"]
    for k, v in res["compared"].items():
        log(f"{k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.monotonic() if t0 is None else t0
    p = argparse.ArgumentParser(description="One run of one benchmark cell "
                                "of dynamorph_tpu_torch.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = Spec(Path(__file__).resolve().parents[2])
    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); this machine "
            f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    return report(run_cell(spec, args.workload, args.seed, args.seconds,
                           bool(args.trace), t0))
