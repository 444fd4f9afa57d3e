"""Time the tiled codebook-search kernels at other tile shapes than the
shipped ones, on the card.

Usage, from the root of a checkout:
    python -m dynamorph_tpu_torch.ops.vq_tile_sweep            # vq_indices
    python -m dynamorph_tpu_torch.ops.vq_tile_sweep --lookup   # vq_lookup

Each variant is ``csrc/vq_lookup.cu`` with one set of tile constants
replaced (threads a block, rows and codes a thread, lanes that share rows,
resident blocks an SM; for the lookup, whether its grid is persistent) or,
for "blocked rows", with each thread's rows contiguous instead of
interleaved. The shared set (``kTileThreads`` ...) tiles vq_indices at both
widths and vq_lookup at D = 64 (``kZ32Persistent``); the ``kZ16*`` set tiles
vq_lookup at D = 16. All variants compile at once with the flags of
``ops/_build.py`` into ``build/kernels/sweep/``.

- Default: each variant's vq_indices runs at the z32 training shape
  (N = 786,432, D = 64, K = 512); its codes must equal the shipped lookup
  kernel's.
- ``--lookup``: each variant's vq_lookup runs at the z16 and z32 encode
  shapes (N = 131,072, D = 16, K = 64 and N = 524,288, D = 64, K = 512);
  its codes and q must equal the shipped lookup kernel's bit for bit. The
  ablations (``ABLATIONS``: the shipped lookup with one part cut out, so
  wrong by design and not checked) show what each part costs.

Inputs are seeded random rows. Device time: 20 launches captured in a CUDA
graph and replayed between CUDA events, twice, in turns with the other
variants. One JSON line a variant and shape: ms (the lower of the two
turns), share of the bound, registers, static shared memory and spills from
``-Xptxas -v`` (``ptxas_usage``, which ``chip_smoke.py`` reads the shipped
build with).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys

import torch

from . import _build, vq

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SHAPE = (786432, 64, 512)
LOOKUP_SHAPES = {"z16": (131072, 16, 64), "z32": (524288, 64, 512)}
# name: (constant set, its values in the order of CONSTANTS); None keeps
# the shipped constants
VARIANTS = {
    "shipped": None,
    "blocked rows": None,
    "8x8, 128 threads, 3 blocks": ("shared", (128, 8, 8, 8, 3)),
    "8x8, 256 threads, 1 block": ("shared", (256, 8, 8, 16, 1)),
    "8x4, 128 threads, 4 blocks": ("shared", (128, 8, 4, 16, 4)),
    "4x8, 256 threads, 2 blocks": ("shared", (256, 4, 8, 8, 2)),
}
LOOKUP_VARIANTS = {
    "shipped": None,
    "z16: 8x4, 256 threads, 2 blocks, one tile a block":
        ("z16", (256, 8, 4, 16, 2, 0)),
    "z16: 8x4, 256 threads, 2 blocks, persistent":
        ("z16", (256, 8, 4, 16, 2, 1)),
    "z16: 4x16, 256 threads, 2 blocks, one tile a block":
        ("z16", (256, 4, 16, 4, 2, 0)),
    "z16: 4x16, 128 threads, 4 blocks, persistent":
        ("z16", (128, 4, 16, 4, 4, 1)),
    "z16: 4x8, 256 threads, 2 blocks, persistent":
        ("z16", (256, 4, 8, 8, 2, 1)),
    "z16: 2x16, 256 threads, 2 blocks, persistent":
        ("z16", (256, 2, 16, 4, 2, 1)),
    "z16: 2x32, 256 threads, 2 blocks, persistent":
        ("z16", (256, 2, 32, 2, 2, 1)),
    "z16: 4x8, 256 threads, 3 blocks, persistent":
        ("z16", (256, 4, 8, 8, 3, 1)),
    "z16: 4x8, 256 threads, 4 blocks, persistent":
        ("z16", (256, 4, 8, 8, 4, 1)),
    "z16: 2x16, 256 threads, 3 blocks, persistent":
        ("z16", (256, 2, 16, 4, 3, 1)),
    "z16: 2x16, 256 threads, 4 blocks, persistent":
        ("z16", (256, 2, 16, 4, 4, 1)),
    "z32: persistent": ("z32", (1,)),
    "z32: 8x8, 256 threads, 1 block": ("shared", (256, 8, 8, 16, 1)),
}
# name: (source text of the shipped lookup, what replaces it)
ABLATIONS = {
    "ablation: no q copy": (
        "q4[f] = __ldg(cb4 + static_cast<int64_t>(sidx[r]) * V + c);", ";"),
    "ablation: no search": (
        "search_chunk<T>(zs, e, norm, k0, k, cg, rg, best, best_k);", ";"),
    "ablation: no z load": (
        "cp_async16(zs + r * T::kStride + 4 * q, z + (row0 + r) * T::D + "
        "4 * q);", ";"),
}
CONSTANTS = {
    # threads, rows a thread, codes a thread, lanes sharing rows, blocks an
    # SM (and for the z16 lookup whether its grid is persistent)
    "shared": ("kTileThreads", "kRowsPerThread", "kCodesPerThread",
               "kCodeGroups", "kMinBlocks"),
    "z16": ("kZ16Threads", "kZ16RowsPerThread", "kZ16CodesPerThread",
            "kZ16CodeGroups", "kZ16MinBlocks", "kZ16Persistent"),
    "z32": ("kZ32Persistent",),
}


def variant_source(name: str, lookup: bool = False) -> str:
    src = (_build.CSRC / "vq_lookup.cu").read_text()
    if lookup and name in ABLATIONS:
        old, new = ABLATIONS[name]
        if old not in src:
            raise ValueError(f"{name}: the source no longer holds {old!r}")
        return src.replace(old, new)
    spec = (LOOKUP_VARIANTS if lookup else VARIANTS)[name]
    if name == "blocked rows":
        src = src.replace("rg + T::kRowGroups * i", "T::kRowsPerThread * rg + i")
    elif spec is not None:
        which, values = spec
        for const, value in zip(CONSTANTS[which], values):
            src, n = re.subn(rf"constexpr int {const} = \d+;",
                             f"constexpr int {const} = {value};", src)
            if n != 1:
                raise ValueError(f"{const} is defined {n} times in the source")
    return src


def build_all(lookup: bool = False) -> dict:
    """Compile every variant in parallel: {name: (library, ptxas log)}."""
    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate({**LOOKUP_VARIANTS, **ABLATIONS} if lookup
                             else VARIANTS):
        cu = out_dir / f"variant{i}.cu"
        cu.write_text(variant_source(name, lookup))
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
    """Device ms per call: ``iters`` calls captured in one CUDA graph,
    replayed 3 times between CUDA events (``fn`` launches on the current
    stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def entry(lib, name: str, n_ptrs: int):
    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, *args):
    """A launch of ``fn`` on the current stream; tensors in ``args`` are
    passed by pointer and kept alive by the closure."""
    def launch():
        err = fn(*(a.data_ptr() if torch.is_tensor(a) else a for a in args),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
    return launch


def indices_runs(built: dict) -> dict:
    """{(name, shape label): (launch, bound ms, kernel name, D)}."""
    n, d, k = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    z = torch.randn(n, d, generator=g, device="cuda")
    cb = torch.randn(k, d, generator=g, device="cuda")
    _, want = vq._vq_lookup_cuda(z, cb)
    bound_ms = 2 * n * k * d / FP32_FLOP_PER_S * 1e3
    runs = {}
    for name, (lib, _) in built.items():
        idx = torch.empty(n, dtype=torch.int32, device="cuda")
        launch = launcher(entry(lib, "vq_indices_f32", 3), z, cb, idx, n, d,
                          k)
        launch()
        torch.cuda.synchronize()
        if not torch.equal(idx, want):
            raise AssertionError(f"{name}: codes differ from vq_lookup's "
                                 f"on {int((idx != want).sum())} rows")
        runs[name, "z32 training"] = (launch, bound_ms, "vq_indices_kernel",
                                      d)
    return runs


def lookup_runs(built: dict) -> dict:
    runs = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, (n, d, k) in LOOKUP_SHAPES.items():
        z = torch.randn(n, d, generator=g, device="cuda")
        cb = torch.randn(k, d, generator=g, device="cuda")
        q_want, want = vq._vq_lookup_cuda(z, cb)
        bound_ms = max(4 * (2 * n * d + k * d + n) / HBM_BYTES_PER_S,
                       2 * n * k * d / FP32_FLOP_PER_S) * 1e3
        for name, (lib, _) in built.items():
            q = torch.empty_like(z)
            idx = torch.empty(n, dtype=torch.int32, device="cuda")
            launch = launcher(entry(lib, "vq_lookup_f32", 4), z, cb, q, idx,
                              n, d, k)
            launch()
            torch.cuda.synchronize()
            if name not in ABLATIONS and not (torch.equal(idx, want) and
                                              torch.equal(q, q_want)):
                raise AssertionError(f"{name} at {label}: codes or q differ "
                                     "from the shipped lookup's")
            runs[name, label] = (launch, bound_ms, "vq_lookup_kernel", d)
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lookup", action="store_true",
                    help="sweep vq_lookup at the encode shapes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vq_tile_sweep needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    built = build_all(args.lookup)
    runs = (lookup_runs if args.lookup else indices_runs)(built)
    keys = list(runs)
    ms = {key: [] for key in keys}
    for order in (keys, keys[::-1]):
        for key in order:
            ms[key].append(time_ms(runs[key][0]))
    for key in keys:
        name, label = key
        _, bound_ms, kernel, d = runs[key]
        best = min(ms[key])
        print(json.dumps({"variant": name, "shape": label, "ms": best,
                          "turns_ms": ms[key], "bound_share": bound_ms / best,
                          **ptxas_usage(built[name][1], kernel)[d]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
