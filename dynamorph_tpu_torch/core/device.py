"""Device resolution and fp32 numerics for the port's entry points."""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Tuple, Union

import numpy as np
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


def device_scope(device) -> contextlib.AbstractContextManager:
    """``torch.cuda.device(device)`` for a card, so the work a thread
    queues there goes to that card's current stream; nothing for the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the device: on the
    card through pinned memory and a ``non_blocking`` copy, which is
    ordered on the current stream behind the work already queued there (a
    plain ``.to(device)`` would first wait for that work to finish). The
    pinned block is not reused before the copy is done."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class HostCopy:
    """A device -> host copy started now and waited for later, from any
    thread.

    On the card the tensor is copied ``non_blocking`` into pinned host
    memory and an event is recorded behind the copy on the current stream:
    ``wait`` blocks on that event only, so the copy does not queue behind
    work enqueued after it, and the thread that waits launches no CUDA
    work. A CPU tensor is its own host copy.
    """

    def __init__(self, t: torch.Tensor):
        self.nbytes = t.numel() * t.element_size()
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t.detach()

    def wait(self) -> np.ndarray:
        """The host array, once the copy has landed."""
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()
