"""Native (C++) host ops of the port, built with g++ at first use:

- ``grid_dbscan.cpp``: exact occupancy-grid DBSCAN over integer pixel
  coordinates (instance segmentation), labels identical to sklearn's;
- ``lap.cpp``: dense Jonker-Volgenant LAP solver (tracking, large
  instances);
- ``tiff_lzw.cpp``: the TIFF reader's LZW decoder;
- ``contours.cpp``: cv2's contour tracing and minimum-area rectangle
  (long-axis extraction, morphology).

Each source compiles into ``build/native/lib<name>-<hash>.so`` at the root
of the checkout (git-ignored); the hash covers the source and the flags, so
an edited source is rebuilt and a stale library is never loaded. An
exclusive ``fcntl`` lock on ``build/native/<name>.lock`` is held across the
check and the build, so concurrent processes (test workers) build once and
the others wait for it, then load the finished library. The library is
written under a temporary name and renamed into place, so no process sees
a half-written file. A failed build or load raises ``NativeError``
with g++'s output: nothing falls back to another implementation, nothing
that calls these libraries swallows it, and nothing is written into the
package directory.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")


class NativeError(RuntimeError):
    """A native library failed to build, to load or to solve."""


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``<name>.cpp`` unless it is built already; returns the
    library's path. Raises NativeError if g++ is missing or fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():            # built while this one waited
                return out
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = ["g++", *GXX_FLAGS, "-o", str(tmp),
                   str(SRC_DIR / f"{name}.cpp")]
            try:
                res = subprocess.run(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
            except OSError as e:
                raise NativeError(
                    f"native build of {name} failed: cannot run g++ "
                    f"({e})") from e
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise NativeError(
                    f"native build of {name} failed: g++ exited "
                    f"{res.returncode}\n{res.stdout}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>``, built first if needed."""
    path = build(name)
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise NativeError(f"native load of {path} failed: {e}") from e
