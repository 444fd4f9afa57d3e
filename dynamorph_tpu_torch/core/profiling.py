"""Per-stage wall-clock timing.

``stage_timer`` appends ``{stage, seconds, ...}`` records to a JSONL file
(set ``DYNAMORPH_TIMING_LOG`` or pass a path), used by the pipeline stages.
The times are host clock; a stage that ends in a host copy of its device
results has waited for the device. Each timed stage is also a
``torch.profiler`` range named after it, so a trace of a run can split
its device time by stage.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Iterator, Optional

import torch

log = logging.getLogger(__name__)


@contextlib.contextmanager
def stage_timer(stage: str, log_path: Optional[str] = None,
                **metadata) -> Iterator[None]:
    """Time a pipeline stage; append {stage, seconds, ...} to the timing log."""
    path = log_path or os.environ.get("DYNAMORPH_TIMING_LOG")
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(stage):
            yield
    finally:
        dt = time.perf_counter() - t0
        log.info("[timing] %s: %.3fs", stage, dt)
        if path:
            try:
                rec = {"stage": stage, "seconds": round(dt, 4),
                       "time": time.time(), **metadata}
                with open(path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            except Exception as e:   # telemetry must never mask the
                log.warning("timing log write failed: %s", e)  # stage error
