"""Training metrics: an always-on JSONL log, plus TensorBoard scalars when
``tensorboardX`` imports (the reference's SummaryWriter usage,
run_training.py:536-541)."""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, output_dir: str, use_tensorboard: bool = True):
        os.makedirs(output_dir, exist_ok=True)
        self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(output_dir)

    def write(self, prefix: str, scalars: Dict[str, float], step: int):
        rec = {"step": step, "time": time.time()}
        for k, v in scalars.items():
            rec[f"{prefix}/{k}"] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(f"{prefix}/{k}", float(v), step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
