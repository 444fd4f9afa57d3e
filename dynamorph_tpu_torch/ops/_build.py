"""Build the port's CUDA kernels with ``nvcc`` at first use, and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/kernels/lib<name>-<hash>.so`` beside the package (the directory is
git-ignored); the hash covers the source and the flags, so an edited source
is rebuilt and a stale library is never loaded. Libraries are loaded with
``ctypes``. Nothing here runs at import time: this module imports on a
machine without ``nvcc`` (the CPU tests), and only a kernel launch builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels of dynamorph_tpu_torch are built from source at first "
            "use")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns
    ``{"path", "seconds", "log"}``: ``log`` holds ``nvcc``'s output
    (``-Xptxas -v``: registers, shared memory, spills), kept beside the
    library as ``lib<name>-<hash>.log`` so that a later build of the same
    source returns it too, and ``seconds`` is 0.0 for a library that was
    already built. Raises if the compile fails."""
    out = library_path(name)
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(out), "seconds": 0.0, "log": log}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited "
                           f"{res.returncode}\n{res.stdout}")
    # the log first, so that where the library exists its log does too;
    # each replace is atomic: a half-written file is never seen
    tmp_log = log_path.with_name(f"{log_path.name}.{os.getpid()}.tmp")
    tmp_log.write_text(res.stdout)
    os.replace(tmp_log, log_path)
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "log": res.stdout}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
