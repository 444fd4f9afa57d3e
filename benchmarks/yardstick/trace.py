"""Reading the device trace of a traced window (``torch.profiler``).

``summarize`` turns one process's trace into what the per-layer readers
need: device time by kernel name, the union of device activity over the
window (busy seconds), and the longest idle stretches labelled by the host
operation that ran through them. The kernel families are a frozen copy of
the port's chip script's ``FAMILIES``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

# the label of the benchmark's own range around the traced window
WINDOW = "bench.window"
# entries of a breakdown list
TOP = 10
# the longest idle stretches, labelled by the host operation running
# through them
LABELLED = 400

# kernel families, matched in this order on the lowercased kernel name
# (cuDNN's batch-norm kernels carry "cudnn" too)
FAMILIES = (
    ("vq_indices kernel", ("vq_indices",)),
    ("vq_lookup kernel", ("vq_lookup",)),
    ("nccl", ("nccl",)),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    # "cf32": the complex products of cuDNN's FFT convolutions
    ("convolutions (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                              "winograd", "fft", "cf32")),
    ("matrix products (cuBLAS)", ("gemm", "cutlass")),
    ("Adam (foreach)", ("adam", "multi_tensor")),
)
OTHER = "other (elementwise, reductions, copies)"


def family(name: str) -> str:
    lname = name.lower()
    for fam, keys in FAMILIES:
        if any(k in lname for k in keys):
            return fam
    return OTHER


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")()
                                               * 1000)


def _union(intervals: np.ndarray) -> np.ndarray:
    """Disjoint sorted (start, end) rows covering ``intervals``."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    stops = ends[np.append(idx[1:] - 1, len(iv) - 1)]
    return np.stack([starts, stops], 1)


def summarize(prof) -> Optional[Dict]:
    """One process's trace: {"window_s", "busy_s", "kernels": {name:
    [count, seconds]}, "gaps": [[host label, seconds], ...] (the idle
    stretches, summed by what the host ran through them, largest
    first)}, or None where the trace holds no device activity."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    window = None
    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, dur = _ns(e, "start"), _ns(e, "duration")
        if e.device_type() == cuda:
            if not e.is_user_annotation() and dur > 0:
                dev.append((name, start, start + dur))
        elif name == WINDOW:
            window = (start, start + dur)
        elif dur > 0:
            cpu.append((name, start, start + dur))
    if window is None or not dev:
        return None
    w0, w1 = window
    kernels: Dict[str, List[float]] = {}
    spans = []
    for name, s, t in dev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (t - s) / 1e9
        spans.append((s, t))
    busy = _union(np.asarray(spans, dtype=np.int64))
    busy_s = float(np.sum(busy[:, 1] - busy[:, 0])) / 1e9
    # idle stretches: between the window's edges and the busy spans
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1],
                           kind="stable")][:LABELLED]
    c_start = np.asarray([c[1] for c in cpu], dtype=np.int64)
    c_end = np.asarray([c[2] for c in cpu], dtype=np.int64)
    labels: Dict[str, float] = {}
    for s, t in gaps:
        mid = (s + t) // 2
        inside = np.flatnonzero((c_start <= mid) & (c_end >= mid))
        if len(inside):
            # the innermost host operation running through the gap
            j = inside[np.argmin(c_end[inside] - c_start[inside])]
            label = cpu[j][0]
        else:
            label = "host: no profiled operation"
        labels[label] = labels.get(label, 0.0) + (t - s) / 1e9
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_s,
        "kernels": kernels,
        "gaps": sorted(([k, v] for k, v in labels.items()),
                       key=lambda kv: -kv[1])[:TOP],
    }


def family_seconds(summary: Dict) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, (_, sec) in summary["kernels"].items():
        fam = family(name)
        out[fam] = out.get(fam, 0.0) + sec
    return out


def top_kernels(summary: Dict) -> List[list]:
    return [[name[:160], sec] for name, (_, sec) in sorted(
        summary["kernels"].items(), key=lambda kv: -kv[1][1])[:TOP]]
