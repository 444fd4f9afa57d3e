"""Time ``vq_indices_kernel`` at other tile shapes than the shipped one, on
the card.

Usage, from the root of a checkout:
    python -m dynamorph_tpu_torch.ops.vq_tile_sweep

Each variant is ``csrc/vq_lookup.cu`` with its tile constants replaced
(threads a block, rows and codes a thread, lanes that share rows, resident
blocks an SM) or, for "blocked rows", with each thread's rows contiguous
instead of interleaved. All variants compile at once with the flags of
``ops/_build.py`` into ``build/kernels/sweep/``. Each then runs at the z32
training shape (N = 786,432, D = 64, K = 512) on seeded random rows; its
codes must equal the shipped lookup kernel's, and its device time is taken
with CUDA events over 20 launches, twice, in turns with the others. One
JSON line a variant: ms (the lower of the two turns), share of the fp32
bound, registers, static shared memory and spills from ``-Xptxas -v``
(``ptxas_usage``, which ``chip_smoke.py`` reads the shipped build with).
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import torch

from . import _build, vq

SHAPE = (786432, 64, 512)
BOUND_MS = 2 * SHAPE[0] * SHAPE[1] * SHAPE[2] / 67e12 * 1e3
# name: (threads, rows a thread, codes a thread, lanes sharing rows,
# blocks an SM); None keeps the shipped constants
VARIANTS = {
    "shipped": None,
    "blocked rows": None,
    "8x8, 128 threads, 3 blocks": (128, 8, 8, 8, 3),
    "8x8, 256 threads, 1 block": (256, 8, 8, 16, 1),
    "8x4, 128 threads, 4 blocks": (128, 8, 4, 16, 4),
    "4x8, 256 threads, 2 blocks": (256, 4, 8, 8, 2),
}
CONSTANTS = ("kTileThreads", "kRowsPerThread", "kCodesPerThread",
             "kCodeGroups", "kMinBlocks")


def variant_source(name: str) -> str:
    src = (_build.CSRC / "vq_lookup.cu").read_text()
    if name == "blocked rows":
        src = src.replace("rg + kRowGroups * i", "kRowsPerThread * rg + i")
    elif VARIANTS[name] is not None:
        for const, value in zip(CONSTANTS, VARIANTS[name]):
            src, n = re.subn(rf"constexpr int {const} = \d+;",
                             f"constexpr int {const} = {value};", src)
            if n != 1:
                raise ValueError(f"{const} is defined {n} times in the source")
    return src


def build_all() -> dict:
    """Compile every variant in parallel: {name: (library, ptxas log)}."""
    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(VARIANTS):
        cu = out_dir / f"variant{i}.cu"
        cu.write_text(variant_source(name))
        lib = out_dir / f"libvariant{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        built[name] = (lib, log)
    return built


def ptxas_usage(build_log: str, kernel: str) -> dict:
    """Registers, static shared memory and spills of each instantiation of
    ``kernel``, from nvcc's ``-Xptxas -v`` output: {D: {...}}."""
    usage, d = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(kernel + r"ILi(\d+)E", line)
            d = int(m.group(1)) if m else None
            if d is not None:
                usage[d] = {}
        elif d is not None and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            usage[d].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        elif d is not None and "Used" in line and "registers" in line:
            usage[d]["registers"] = int(re.search(r"Used (\d+) registers",
                                                  line).group(1))
            m = re.search(r"(\d+) bytes smem", line)
            usage[d]["static_smem"] = int(m.group(1)) if m else 0
    return usage


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("vq_tile_sweep needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    built = build_all()
    n, d, k = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    z = torch.randn(n, d, generator=g, device="cuda")
    cb = torch.randn(k, d, generator=g, device="cuda")
    _, want = vq._vq_lookup_cuda(z, cb)
    stream = torch.cuda.current_stream().cuda_stream
    runs = {}
    for name, (lib, log) in built.items():
        fn = ctypes.CDLL(str(lib)).vq_indices_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        idx = torch.empty(n, dtype=torch.int32, device="cuda")

        def launch(fn=fn, idx=idx):
            err = fn(z.data_ptr(), cb.data_ptr(), idx.data_ptr(), n, d, k,
                     stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")

        launch()
        torch.cuda.synchronize()
        if not torch.equal(idx, want):
            raise AssertionError(f"{name}: codes differ from vq_lookup's "
                                 f"on {int((idx != want).sum())} rows")
        runs[name] = (launch, log)
    names = list(runs)
    ms = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            ms[name].append(time_ms(runs[name][0]))
    for name in names:
        best = min(ms[name])
        print(json.dumps({"variant": name, "ms": best, "turns_ms": ms[name],
                          "bound_share": BOUND_MS / best,
                          **ptxas_usage(runs[name][1],
                                        "vq_indices_kernel")[d]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
