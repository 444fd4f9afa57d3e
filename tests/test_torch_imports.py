"""The PyTorch port stands alone: it imports neither jax nor the JAX package
(dynamorph_tpu), and it never falls back from a CUDA tensor to the plain
version."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "dynamorph_tpu_torch"

# Imports every port module (and chip_smoke.py) with jax and the JAX package
# blocked, and sklearn, cv2, matplotlib, h5py, tensorflow, torchvision,
# seaborn, pandas and imageio, which the card's machine lacks (matplotlib,
# cv2 and h5py at least once) or which no port module may import at module
# level; and loads every colour map there. The blocker matches "dynamorph_tpu" and "dynamorph_tpu.*"
# exactly: a prefix test would also block dynamorph_tpu_torch.
_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys
sys.modules["jax"] = None
_HOST_ONLY = ("sklearn", "cv2", "matplotlib", "h5py", "tensorflow",
              "torchvision", "seaborn", "pandas", "imageio")

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "dynamorph_tpu" or name.startswith("dynamorph_tpu.") \
                or name.split(".")[0] in _HOST_ONLY:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
for k in [k for k in sys.modules
          if k == "dynamorph_tpu" or k.startswith("dynamorph_tpu.")]:
    del sys.modules[k]
import dynamorph_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    dynamorph_tpu_torch.__path__, "dynamorph_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
from dynamorph_tpu_torch.analysis import raster
# every matplotlib colour map, from the port's own tables
luts = {n: raster.colormap_lut(n) for n in raster._colormap_tables()}
assert len(luts) >= 170 and luts["jet_r"].shape == (256, 3)
import torch.distributed
assert not torch.distributed.is_initialized()   # no import joins a group
assert sys.modules["jax"] is None
assert not [m for m in sys.modules if m.split(".")[0] in _HOST_ONLY]
print(" ".join(names))
print(len(names))
"""

# modules that each slice added, which the blocked import must reach (the
# AST scans below take every file of the package)
_SLICE_MODULES = [
    "dynamorph_tpu_torch.models.vae", "dynamorph_tpu_torch.models.losses",
    "dynamorph_tpu_torch.models.resnet_simclr",
    "dynamorph_tpu_torch.train.triplet_data",
    "dynamorph_tpu_torch.train.adversarial", "dynamorph_tpu_torch.reduce.cpca",
    "dynamorph_tpu_torch.analysis.trajectory_dynamics",
    "dynamorph_tpu_torch.analysis.kmeans",
    "dynamorph_tpu_torch.analysis.state_clustering",
    "dynamorph_tpu_torch.analysis.recon_eval",
    "dynamorph_tpu_torch.analysis.pc_samples",
    "dynamorph_tpu_torch.io.hdf5", "dynamorph_tpu_torch.models.unet_keras",
    "dynamorph_tpu_torch.models.inception_resnet_v2",
    "dynamorph_tpu_torch.seg.keras_import",
    "dynamorph_tpu_torch.analysis.imagenet_baseline",
    "dynamorph_tpu_torch.core.mesh", "dynamorph_tpu_torch.nn.batchnorm",
    "dynamorph_tpu_torch.train.sharded_loss",
    # slice J: the figures, and the modules its fan-out changed
    "dynamorph_tpu_torch.analysis.plots", "dynamorph_tpu_torch.analysis.raster",
    "dynamorph_tpu_torch.core.device", "dynamorph_tpu_torch.seg.inference",
    "dynamorph_tpu_torch.pipeline.patch_vae",
    "dynamorph_tpu_torch.pipeline.fused", "dynamorph_tpu_torch.pipeline.stream",
    "dynamorph_tpu_torch.pipeline.orchestrator",
    "dynamorph_tpu_torch.reduce.scatter",
    # slice K: KAZE, training over local ranks, the tile bucket
    "dynamorph_tpu_torch.analysis.kaze",
    "dynamorph_tpu_torch.analysis.morphology",
    "dynamorph_tpu_torch.cli.run_training",
    "dynamorph_tpu_torch.pipeline.segmentation",
]


def _is_forbidden(module: str) -> bool:
    return module in ("jax", "dynamorph_tpu") or \
        module.startswith(("jax.", "dynamorph_tpu."))


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_scans_cover_the_slice_modules():
    scanned = {str(p.relative_to(ROOT))[:-3].replace("/", ".")
               for p in _sources()}
    assert set(_SLICE_MODULES) <= scanned


def test_port_imports_with_jax_and_jax_package_blocked():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    names, count = res.stdout.strip().splitlines()[-2:]
    assert int(count) >= 30
    assert set(_SLICE_MODULES) <= set(names.split())


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _is_forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _is_forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_cv2_import_in_port(path):
    """The port runs where cv2 is not installed: its PNGs come from
    io/png.py."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
           for a in node.names if a.name.split(".")[0] == "cv2"]
    bad += [node.module for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.level == 0
            and (node.module or "").split(".")[0] == "cv2"]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_h5py_tensorflow_or_torchvision_import(path):
    """Neither the port nor chip_smoke.py imports h5py, tensorflow or
    torchvision, none of which the card's machine has: HDF5 is read by
    io/hdf5.py (and written by chip_smoke.py's own writer), Keras and
    torchvision weights are mapped by name."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module or "" for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.level == 0]
    bad = [m for m in names
           if m.split(".")[0] in ("h5py", "tensorflow", "torchvision")]
    assert not bad, f"{path} imports {bad}"


def _import_time_modules(tree):
    """Top-level names of the modules imported when the module itself is
    imported: every import outside a function body."""
    found = []
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            found += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append((node.module or "").split(".")[0])
        stack.extend(ast.iter_child_nodes(node))
    return found


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_sklearn_or_module_level_matplotlib_in_port(path):
    """The card's machine has neither sklearn nor matplotlib: the port
    never imports sklearn (DBSCAN is native/grid_dbscan.cpp), and imports
    matplotlib only inside the functions that draw an optional figure."""
    tree = ast.parse(path.read_text(), filename=str(path))
    anywhere = [a.name for node in ast.walk(tree)
                if isinstance(node, ast.Import) for a in node.names]
    anywhere += [node.module or "" for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) and node.level == 0]
    assert not [m for m in anywhere if m.split(".")[0] == "sklearn"], path
    assert "matplotlib" not in _import_time_modules(tree), path


_BUILD_AT_ONCE = r"""
import os, sys, time
from pathlib import Path
import numpy as np
import dynamorph_tpu_torch.native as native
build_dir = Path(sys.argv[1])
native.BUILD_DIR = build_dir
(build_dir.parent / f"ready-{os.getpid()}").touch()
deadline = time.time() + 60
while len(list(build_dir.parent.glob("ready-*"))) < 2:
    assert time.time() < deadline
    time.sleep(0.01)
from dynamorph_tpu_torch.native.dbscan import grid_dbscan
from dynamorph_tpu_torch.native.lap import lap_solve
print(lap_solve(np.array([[1.0, 0.0], [0.0, 1.0]]))[1].tolist(),
      grid_dbscan(np.array([[0, 0], [0, 1], [9, 9]]), 1.5, 2,
                  shape=(10, 10)).tolist())
"""


def test_native_libraries_build_once_under_a_lock(tmp_path):
    """The native libraries build into build/native/ (never the package
    directory), named by a hash of source and flags; two processes that
    build at once both load the one library the lock lets one of them
    build."""
    from dynamorph_tpu_torch import native

    assert native.BUILD_DIR == ROOT / "build" / "native"
    for name in ("grid_dbscan", "lap"):
        p = native.library_path(name)
        assert p.parent == native.BUILD_DIR and p.name.startswith(
            f"lib{name}-") and p.suffix == ".so"
    build_dir = tmp_path / "native"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AT_ONCE,
                               str(build_dir)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
        assert out.split() == ["[1,", "0]", "[0,", "0,", "-1]"]
    built = sorted(f.name for f in build_dir.iterdir())
    assert built == sorted([native.library_path("grid_dbscan").name,
                            native.library_path("lap").name,
                            "grid_dbscan.lock", "lap.lock"])
    assert not list(native.SRC_DIR.glob("*.so"))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed g++ build raises with the compiler's output: nothing falls
    back to another implementation."""
    from dynamorph_tpu_torch import native

    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native build of broken failed"):
        native.build("broken")
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("launcher", ["_vq_lookup_cuda", "_vq_indices_cuda",
                                      "_vq_lookup_rowwise_cuda"])
def test_kernel_wrapper_refuses_cpu_tensor(launcher):
    """The CUDA launchers take CUDA tensors only; the CPU path is chosen by
    vq_lookup / vq_indices from the tensor's device, never as a fallback."""
    from dynamorph_tpu_torch.ops import vq

    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(vq, launcher)(torch.zeros(8, 16), torch.zeros(4, 16))


def test_rowwise_oracle_is_on_no_path():
    """The lookup's row-wise kernel is a test oracle: no module of the
    models, pipeline, trainer or CLIs names it."""
    hits = [str(p.relative_to(ROOT)) for sub in ("models", "pipeline",
                                                 "train", "cli")
            for p in sorted((PORT / sub).rglob("*.py"))
            if "rowwise" in p.read_text()]
    assert not hits


def test_resolve_device_raises_without_card():
    from dynamorph_tpu_torch.core.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_fp32_strict_restores_flags():
    from dynamorph_tpu_torch.core.device import fp32_strict

    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.benchmark)
    with fp32_strict():
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.benchmark) == before


def test_fp32_strict_overlapping_threads():
    """A block that ends on one thread leaves TF32 off for a block still
    open on another (the recon writer thread beside the main thread's
    encode); the last block to end restores the switches."""
    import threading

    from dynamorph_tpu_torch.core.device import fp32_strict

    def tf32():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    before = tf32()
    entered, release, done = (threading.Event() for _ in range(3))
    seen = []

    def writer():
        with fp32_strict():
            seen.append(tf32())
            entered.set()
            release.wait(10)
        done.set()

    t = threading.Thread(target=writer)
    t.start()
    assert entered.wait(10)
    with fp32_strict():
        release.set()
        assert done.wait(10)       # the writer's block has ended
        assert tf32() == (False, False)
    t.join(10)
    assert seen == [(False, False)]
    assert tf32() == before


def test_kernel_library_path_tracks_source():
    """The build cache key covers the .cu source, so an edited kernel is
    rebuilt rather than a stale library loaded."""
    from dynamorph_tpu_torch.ops import _build

    assert (_build.CSRC / "vq_lookup.cu").exists()
    p = _build.library_path("vq_lookup")
    assert p.parent == _build.BUILD_DIR and p.name.startswith("libvq_lookup-")
