"""Spans, counters and per-stage wall-clock timing.

A ``Record`` holds one call's spans and counters. While it records, each
span is a ``torch.profiler.record_function`` range, so a trace of the run
lands it on the same clock as the CUDA kernels, and a host-clock sum of its
count and seconds in the record; a counter is a sum. While it does not, a
span is a flag test and a no-op context, and a counter nothing. A call
records while a ``torch.profiler`` is recording on the thread that starts
it, or while ``DYNAMORPH_TIMING_LOG`` names a JSONL file (``recording``);
the decision is made once, at the call's start, and the record is handed
to the threads that work for the call.

``stage_timer`` times a pipeline stage with one span and appends ``{stage,
seconds, time, ...}`` to the timing log (set ``DYNAMORPH_TIMING_LOG`` or
pass a path). The times are host clock; a stage that ends in a host copy
of its device results has waited for the device.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from typing import Dict, Iterator, Optional

import torch

log = logging.getLogger(__name__)

LOG_ENV = "DYNAMORPH_TIMING_LOG"

# the last recorded call of each kind in this process (``Record.keep``)
_LAST: Dict[str, Dict] = {}


def recording() -> bool:
    """Whether a call starting now on this thread records: a
    ``torch.profiler`` is recording, or the timing log is set."""
    return bool(os.environ.get(LOG_ENV)) or torch.autograd._profiler_enabled()


class _Span:
    __slots__ = ("_record", "_name", "_range", "_t0")

    def __init__(self, record: "Record", name: str):
        self._record, self._name = record, name

    def __enter__(self):
        self._range = torch.profiler.record_function(self._name)
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t0
        self._range.__exit__(*exc)
        self._record._add(self._name, dt)
        return False


_OFF_SPAN = contextlib.nullcontext()


class Record:
    """One call's spans ({name: [count, ns]}) and counters ({name: n}),
    safe to add to from several threads. ``on`` is fixed when it is made;
    ``log_path`` is the JSONL file that ``log`` appends to, if any."""

    def __init__(self, on: bool, log_path: Optional[str] = None):
        self.on = on
        self.log_path = log_path
        self._spans: Dict[str, list] = {}
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def of_call(cls) -> "Record":
        """The record of a call starting now on this thread: on while
        ``recording()``, and logging where the timing log is set."""
        return cls(recording(), os.environ.get(LOG_ENV) or None)

    def span(self, name: str):
        """A context that times its block as the span ``name``."""
        return _Span(self, name) if self.on else _OFF_SPAN

    def count(self, name: str, n: int = 1) -> None:
        if self.on:
            with self._lock:
                self._counters[name] = self._counters.get(name, 0) + n

    def _add(self, name: str, ns: int) -> None:
        with self._lock:
            s = self._spans.setdefault(name, [0, 0])
            s[0] += 1
            s[1] += ns

    def snapshot(self):
        """The totals so far, for ``totals(since=...)``."""
        with self._lock:
            return ({k: tuple(v) for k, v in self._spans.items()},
                    dict(self._counters))

    def totals(self, since=None) -> Dict:
        """{"spans": {name: [count, seconds]}, "counters": {name: n}}, of
        the whole record or of what was added after the ``since``
        snapshot; a counter counted since then is there even at 0."""
        spans, counters = self.snapshot()
        s0, c0 = since or ({}, {})
        return {
            "spans": {k: [c - s0.get(k, (0, 0))[0],
                          (ns - s0.get(k, (0, 0))[1]) / 1e9]
                      for k, (c, ns) in spans.items()
                      if c != s0.get(k, (0, 0))[0]},
            "counters": {k: n - c0.get(k, 0) for k, n in counters.items()
                         if k not in c0 or n != c0[k]}}

    def log(self, stage: str, seconds: float, **fields) -> None:
        """Appends {stage, seconds, time, **fields} to the timing log, if
        the record has one."""
        if self.log_path:
            _append(self.log_path, {"stage": stage, "seconds": seconds,
                                    "time": time.time(), **fields})

    def keep(self, kind: str, root: str, **fields) -> None:
        """Ends a recorded call whose root span is ``root``: {**fields,
        "seconds" (the root's), "spans", "counters"} becomes the process's
        last record of ``kind`` (``last_record``) and a line of the timing
        log. An unrecorded call keeps nothing."""
        if not self.on:
            return
        totals = self.totals()
        call = {**fields, "seconds": totals["spans"][root][1], **totals}
        _LAST[kind] = call
        self.log(kind, **call)


# a record that never records: the default where a caller passes none
OFF = Record(False)


def last_record(kind: str) -> Optional[Dict]:
    """The last recorded call of ``kind`` in this process (e.g.
    ``"train_vqvae"``: {"device", "seconds", "spans", "counters"}), or
    None. An unrecorded call leaves it as it was."""
    return _LAST.get(kind)


def _append(path: str, rec: Dict) -> None:
    try:
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except Exception as e:   # telemetry must never mask the
        log.warning("timing log write failed: %s", e)  # stage error


@contextlib.contextmanager
def stage_timer(stage: str, log_path: Optional[str] = None,
                **metadata) -> Iterator[None]:
    """Time a pipeline stage; append {stage, seconds, ...} to the timing log."""
    rec = Record(True, log_path or os.environ.get(LOG_ENV))
    try:
        with rec.span(stage):
            yield
    finally:
        dt = rec.totals()["spans"][stage][1]
        log.info("[timing] %s: %.3fs", stage, dt)
        rec.log(stage, round(dt, 4), **metadata)
