"""Device resolution and fp32 numerics for the port's entry points."""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Tuple, Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    The default is the card. Without a usable card the call raises: the
    port never drops to the CPU unless the caller asks for it with
    ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


# The TF32 switches are process-wide, and strict blocks may overlap across
# threads (an io.prefetch.AsyncWriter thread writes recon images while the
# main thread encodes the next well). So the blocks are counted: the first
# to enter saves and clears the switches, the last to leave restores them.
_tf32_lock = threading.Lock()
_tf32_depth = 0
_tf32_saved: Optional[Tuple[bool, bool]] = None


@contextlib.contextmanager
def fp32_strict() -> Iterator[None]:
    """Full IEEE fp32 for convolutions and matrix products inside the block.

    cuDNN runs fp32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
    decimal digits; the JAX reference is full fp32. Both TF32 switches
    (cuDNN's and cuBLAS's) are off while any thread is inside a block, and
    are restored when the last block on any thread ends, so the caller's
    settings are untouched after it.
    """
    global _tf32_depth, _tf32_saved
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    with _tf32_lock:
        if _tf32_depth == 0:
            _tf32_saved = (cudnn.allow_tf32, matmul.allow_tf32)
            cudnn.allow_tf32 = False
            matmul.allow_tf32 = False
        _tf32_depth += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_depth -= 1
            if _tf32_depth == 0:
                cudnn.allow_tf32, matmul.allow_tf32 = _tf32_saved
                _tf32_saved = None
