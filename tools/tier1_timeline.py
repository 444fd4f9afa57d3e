"""A pytest plugin that records when each test file ran under xdist: its
worker, the seconds from the session's start to its first and its last
report, the summed durations of its reports and its count of calls.

Tier-1 runs with ``--dist loadfile``, whose queue orders the files by
their count of tests, largest first, so the order in which files start
sets the run's tail. Run the tier-1 command from the repo root with
``PYTHONPATH=tools`` in its environment and ``-p tier1_timeline`` added;
the controller writes ``build/tier1_timeline.json`` (or the path in
``TIER1_TIMELINE``) at the session's end.
"""
from __future__ import annotations

import json
import os
import time

_T0 = time.time()
_FILES: dict = {}


def pytest_runtest_logreport(report):
    node = getattr(report, "node", None)
    worker = getattr(getattr(node, "gateway", None), "id", "main")
    now = time.time() - _T0
    rec = _FILES.setdefault(report.nodeid.split("::")[0], {
        "worker": worker, "first": now, "last": now, "dur": 0.0, "calls": 0})
    rec["last"] = now
    rec["dur"] += report.duration
    rec["calls"] += report.when == "call"


def pytest_sessionfinish(session):
    if hasattr(session.config, "workerinput"):
        return
    path = os.environ.get("TIER1_TIMELINE", os.path.join(
        "build", "tier1_timeline.json"))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"total": time.time() - _T0, "files": _FILES}, fh,
                  indent=1)
