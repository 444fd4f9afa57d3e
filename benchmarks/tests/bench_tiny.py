"""A copy of the benchmark at a size a CPU test holds: the published
widths, batches of 16 and 32 x 32 patches, in a temporary directory."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_LIMITS = {"loss_gap": {"limit": 1e-3}, "grad_gap": {"limit": 1e-3},
               "change_gap": {"limit": 1e-2}, "val_gap": {"limit": 1e-2}}


def tiny_copy(tmp: Path, ranks: int = 1) -> Path:
    """A checkout-like root under ``tmp``: BENCHMARK.json and benchmarks/
    with a tiny configuration per network, a tiny traffic mix and a cell
    for each (named ``<network>.tiny``), limits and metrics as the
    benchmark's."""
    root = tmp / "root"
    shutil.copytree(BENCH, root / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bd = root / "benchmarks"
    cells = []
    for name in ("vqvae_z32", "vqvae_z16"):
        cfg = json.loads((bd / "configs" / f"{name}.json").read_text())
        cfg["batch_size"] = 16
        (bd / "configs" / f"{name}_tiny.json").write_text(json.dumps(cfg))
        bench["configs"].append(
            {"name": f"{name}_tiny", "source": "a test", "reduced": [],
             "file": f"benchmarks/configs/{name}_tiny.json", "why": "a test"})
        cell = f"{name}.tiny"
        cells.append(cell)
        bench["workloads"].append(
            {"name": cell, "config": f"{name}_tiny", "traffic": "tiny",
             "chips": ranks, "why": "a test"})
        (bd / "limits" / f"{cell}.json").write_text(json.dumps(TINY_LIMITS))
    # over ranks, enough rows for one whole validation batch
    (bd / "traffic" / "tiny.json").write_text(json.dumps(
        {"patches": 80 if ranks == 1 else 120 * ranks, "patch_size": 32,
         "trajectory_frames": [4, 8],
         "ranks": ranks, "trace_seconds": 1}))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and any(
                w.startswith("vqvae_z32.train_b768") for w in m["workloads"]):
            m["workloads"] = m["workloads"] + cells
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def spec_of(root: Path):
    from yardstick.spec import Spec
    return Spec(root, root / "benchmarks")
