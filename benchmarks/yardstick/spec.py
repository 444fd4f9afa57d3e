"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: the file its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<name>.json``;
- a metric: its reader ``metrics/<name>.py``, whose ``read(ctx)`` returns
  the value or None where the run holds nothing to read;
- a cell's limits for ``correct``: ``limits/<workload>.json``.

A new cell, configuration, traffic mix or metric is new files and new
entries; no file here changes for it.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
HERE = Path(__file__).resolve().parents[1]


class Spec:
    def __init__(self, root: Path, bench_dir: Path = HERE):
        self.root = Path(root)
        self.dir = Path(bench_dir)
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    @staticmethod
    def _by_name(entries: List[Dict], name: str, what: str) -> Dict:
        for e in entries:
            if e["name"] == name:
                return e
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")

    def _json(self, path: Path) -> Dict:
        with open(path) as f:
            return json.load(f)

    def cell(self, workload: str) -> Dict:
        return self._by_name(self.bench["workloads"], workload, "workload")

    def config(self, name: str) -> Dict:
        entry = self._by_name(self.bench["configs"], name, "config")
        return self._json(self.root / entry["file"])

    def traffic(self, name: str) -> Dict:
        return self._json(self.dir / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> Dict:
        return self._json(self.dir / "limits" / f"{workload}.json")

    def end_to_end(self, workload: str) -> List[Dict]:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.bench["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[Dict]:
        """The per-layer metrics the cell reports: those that list it, and
        those that list no cells and move a metric it reports."""
        moves = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.bench["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in moves)]

    def reader(self, metric: str) -> Callable:
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + re.sub(r"\W", "_", metric), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
