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
# blocked. The blocker matches "dynamorph_tpu" and "dynamorph_tpu.*" exactly:
# a prefix test would also block dynamorph_tpu_torch.
_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys
sys.modules["jax"] = None

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "dynamorph_tpu" or name.startswith("dynamorph_tpu."):
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
assert sys.modules["jax"] is None
print(len(names))
"""


def _is_forbidden(module: str) -> bool:
    return module in ("jax", "dynamorph_tpu") or \
        module.startswith(("jax.", "dynamorph_tpu."))


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_with_jax_and_jax_package_blocked():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert int(res.stdout.strip().splitlines()[-1]) >= 20


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


@pytest.mark.parametrize("launcher", ["_vq_lookup_cuda", "_vq_indices_cuda"])
def test_kernel_wrapper_refuses_cpu_tensor(launcher):
    """The CUDA launchers take CUDA tensors only; the CPU path is chosen by
    vq_lookup / vq_indices from the tensor's device, never as a fallback."""
    from dynamorph_tpu_torch.ops import vq

    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(vq, launcher)(torch.zeros(8, 16), torch.zeros(4, 16))


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
