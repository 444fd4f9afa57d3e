"""Process groups, the collectives of data-parallel training, and the
fan-out over a process's local devices — the port of
``dynamorph_tpu/core/mesh.py``.

Two shapes of parallelism, as in the JAX package:

- **Across processes**: one process per rank in a ``torch.distributed``
  process group (the JAX package's global mesh after ``init_multihost``).
  Training runs the same data-parallel step on every rank
  (``train/steps.py``); the stage CLIs and the orchestrator split their
  share-nothing work with ``process_slice``.
- **Within one process**: batches fanned out over a list of the process's
  local devices (the JAX package's ``local_mesh()``): one model replica a
  device, equal chunks in order, results gathered in order
  (``shard_batch``).

No process group exists until ``init_multihost`` is called.

The collectives that a data-parallel step differentiates through
(``all_reduce_sum``, ``all_gather_cat``, ``ring_shift``) take a
communicator: ``ProcessGroupComm`` over the default process group, or any
object with its attributes ``rank`` and ``world`` and its methods
``all_reduce``, ``all_gather``, ``broadcast`` and ``shift`` (the tests drive
several ranks inside one process, one thread each). The communicator of the
step running on this thread is ``current_comm()``, set by
``collective_scope``; the models read it to make their batch reductions
global, so every rank's losses are the global batch's.

Gradient convention (``torch.distributed.nn``'s): the backward of an
all-reduce is an all-reduce, so each rank's gradient is that of the sum of
every rank's copy of the loss, ``world`` times the global batch's gradient;
the step averages the gradients over the ranks.
"""
from __future__ import annotations

import contextlib
import copy
import datetime
import logging
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .device import HostCopy, device_scope, upload

log = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 600.0

# the device init_multihost chose for this rank
_RANK = {"device": None}


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S,
                   device: Optional[torch.device] = None) -> torch.device:
    """Join the process group; call once per process, before any collective.

    ``coordinator`` (``host:port``), ``num_processes`` and ``process_id``
    go together, or none of them is given and torchrun's ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` are read. The rank's
    device is ``device`` when given, else ``cuda:{LOCAL_RANK}``
    (``LOCAL_RANK`` defaults to the rank; ranks beyond the visible cards
    share them, modulo their count); a card is made the current device;
    without a card it is the CPU. The backend is NCCL where every local
    rank has a card of its own and ``gloo`` otherwise (the CPU, or ranks
    that share a card: NCCL refuses two ranks on one GPU). Every
    collective times out after ``timeout_s``.

    Returns the rank's device.
    """
    explicit = (coordinator, num_processes, process_id)
    if any(v is not None for v in explicit) and \
            any(v is None for v in explicit):
        raise ValueError(
            "init_multihost: pass coordinator, num_processes and process_id "
            "together, or none of them (torchrun's RANK, WORLD_SIZE, "
            "MASTER_ADDR and MASTER_PORT are read then)")
    if coordinator is None:
        try:
            rank = int(os.environ["RANK"])
            world = int(os.environ["WORLD_SIZE"])
            coordinator = (f"{os.environ['MASTER_ADDR']}:"
                           f"{os.environ['MASTER_PORT']}")
        except KeyError as e:
            raise ValueError(
                f"init_multihost: no coordinator given and {e} is not set; "
                "pass --coordinator/--num-processes/--process-id or launch "
                "with torchrun") from None
    else:
        rank, world = int(process_id), int(num_processes)
    if not 0 <= rank < world:
        raise ValueError(f"init_multihost: process id {rank} not in "
                         f"[0, {world})")
    if dist.is_initialized():
        raise RuntimeError("init_multihost: the process group exists already")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device is not None:
        device = _indexed(device)
    elif n_cards:
        device = torch.device("cuda", local_rank % n_cards)
    else:
        device = torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if n_cards and local_world <= n_cards else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    _RANK["device"] = device
    log.info("rank %d/%d on %s over %s", rank, world, device, backend)
    return device


# one local rank: read the launch spec, join the group, run the target
_LOCAL_RANK_MAIN = """
import pickle, sys
with open(sys.argv[1], "rb") as f:
    spec = pickle.load(f)
sys.path[:] = spec["path"]
from dynamorph_tpu_torch.core import mesh
mesh._local_rank(spec)
"""


def _local_rank(spec: dict) -> None:
    """The body of one local rank (``run_local_ranks``): join the group on
    this rank's device, call the target, pickle its result."""
    rank = int(os.environ["RANK"])
    init_multihost(backend=spec["backend"],
                   device=torch.device(spec["devices"][rank]))
    try:
        fn, args = pickle.loads(spec["call"])
        result = fn(*args)
        with open(os.path.join(spec["dir"], f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        shutdown_multihost()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read(log_file) -> str:
    log_file.seek(0)
    return log_file.read()


def local_backend(devices: Sequence[torch.device]) -> str:
    """NCCL when every device is a card of its own, gloo otherwise (the
    CPU, or ranks that share a card), as ``init_multihost`` chooses."""
    devices = [_indexed(d) for d in devices]
    own_cards = all(d.type == "cuda" for d in devices) and \
        len(set(devices)) == len(devices)
    return "nccl" if own_cards else "gloo"


# how often run_local_ranks looks at its ranks, and how long the others
# get to end with their own errors once one has failed
_POLL_S = 0.2
_GRACE_S = 5.0


def run_local_ranks(fn, args: tuple, devices: Sequence) -> list:
    """``fn(*args)`` on one process a device, as a process group: rank r
    runs on ``devices[r]`` (``init_multihost(device=)``), the ranks meet
    over a loopback TCP address on a free port, and the backend is
    ``local_backend(devices)``. ``fn`` and ``args`` are pickled (``fn`` by
    import path); the children start afresh (no fork of a process that
    may hold the card) with this process's ``sys.path``, and the
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and
    ``MASTER_*`` variables set in their environment only. A rank's
    standard output is this process's; its standard error goes to a log,
    rank 0's copied to this process's standard error at the end.

    Returns every rank's result, in rank order. When a rank fails, the
    others get ``_GRACE_S`` to end with their own errors and are then
    stopped, and ``RuntimeError`` names each rank that failed, with the
    end of its log; a rank stuck in a collective fails by itself after
    the collectives' timeout (``DEFAULT_TIMEOUT_S``).
    """
    devices = [str(_indexed(d)) for d in devices]
    world = len(devices)
    with tempfile.TemporaryDirectory(prefix="local_ranks_") as tmp:
        spec = dict(path=list(sys.path), devices=devices,
                    backend=local_backend(devices), dir=tmp,
                    call=pickle.dumps((fn, args)))
        spec_path = os.path.join(tmp, "spec.pkl")
        with open(spec_path, "wb") as f:
            pickle.dump(spec, f)
        port = _free_port()
        procs, logs = [], []
        try:
            for r in range(world):
                env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                           LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
                logs.append(open(os.path.join(tmp, f"rank_{r}.log"), "w+"))
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _LOCAL_RANK_MAIN, spec_path],
                    env=env, stderr=logs[-1]))
            while True:
                codes = [p.poll() for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    # the others' own errors first: a peer's failure can
                    # surface on a waiting rank before it ends itself
                    end = time.monotonic() + _GRACE_S
                    while time.monotonic() < end and \
                            any(p.poll() is None for p in procs):
                        time.sleep(_POLL_S)
                    codes = [p.poll() for p in procs]
                    failed = [r for r, c in enumerate(codes)
                              if c not in (None, 0)]
                    raise RuntimeError(
                        f"local rank(s) {failed} of {world} failed" + "".join(
                            f"\n--- rank {r} on {devices[r]}, exit code "
                            f"{codes[r]}:\n{_read(logs[r])[-4000:]}"
                            for r in failed))
                if all(c == 0 for c in codes):
                    break
                time.sleep(_POLL_S)
            sys.stderr.write(_read(logs[0]))
            results = []
            for r in range(world):
                with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                    results.append(pickle.load(f))
            return results
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in logs:
                f.close()


def shutdown_multihost() -> None:
    """Leave the process group (a no-op without one)."""
    if is_distributed():
        dist.destroy_process_group()
    _RANK["device"] = None


def is_distributed() -> bool:
    """True inside a process group, of any size (one rank included)."""
    return dist.is_available() and dist.is_initialized()


def is_multiprocess() -> bool:
    return is_distributed() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_main_process() -> bool:
    return process_index() == 0


def rank_device() -> Optional[torch.device]:
    """The device ``init_multihost`` chose for this rank (None before)."""
    return _RANK["device"]


def process_slice(items) -> list:
    """This process's contiguous slice of a share-nothing work list
    (``process_slice``, dynamorph_tpu/core/mesh.py:97-113): the bounds of
    ``np.linspace(0, len(items), world + 1)``, so every item has one owner
    and ranks beyond ``len(items)`` get an empty slice."""
    items = list(items)
    n = process_count()
    if n == 1:
        return items
    bounds = np.linspace(0, len(items), n + 1).astype(int)
    i = process_index()
    return items[bounds[i]:bounds[i + 1]]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_batch(x: np.ndarray, devices: Sequence[torch.device]
                ) -> Tuple[List[torch.Tensor], int]:
    """A host batch padded to a multiple of ``len(devices)`` by repeating its
    last row (edge padding, so padded rows flow through inference like real
    ones) and split into equal chunks, chunk ``i`` on ``devices[i]``.
    Returns (chunks, pad count) so callers can trim results."""
    x = np.asarray(x)
    n_pad = pad_to_multiple(len(x), len(devices)) - len(x)
    if n_pad:
        x = np.pad(x, [(0, n_pad)] + [(0, 0)] * (x.ndim - 1), mode="edge")
    chunk = len(x) // len(devices)
    return [torch.from_numpy(np.ascontiguousarray(
                x[i * chunk:(i + 1) * chunk])).to(d)
            for i, d in enumerate(devices)], n_pad


def local_devices() -> List[torch.device]:
    """This process's CUDA devices, in order: the visible cards, or in a
    process group the rank's own card (the other cards are other ranks',
    as JAX's local devices are a process's own). Empty without a card."""
    if not torch.cuda.is_available():
        return []
    if _RANK["device"] is not None:
        return [_RANK["device"]]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def fan_out_devices(devices: Optional[Sequence], home: torch.device
                    ) -> List[torch.device]:
    """The device list of a fanned-out call: ``devices`` as given, or,
    when None, ``local_devices()`` for an entry on the card and ``[home]``
    for one on the CPU. A list of one device runs the one-device path."""
    if devices is None:
        home = torch.device(home)
        devices = (local_devices() or [home]) if home.type == "cuda" \
            else [home]
    devices = [_indexed(d) for d in devices]
    if not devices:
        raise ValueError("the device list is empty")
    return devices


def device_groups(devices: Sequence, k: int) -> List[list]:
    """``devices`` dealt round-robin into ``k`` groups, group g being
    ``devices[g::k]`` (dynamorph_tpu/pipeline/fused.py:507-508)."""
    return [list(devices[g::k]) for g in range(k)]


def round_to_devices(n: int, n_dev: int) -> int:
    """A batch of ``n`` rows for ``n_dev`` devices: at least ``n_dev`` and
    rounded down to a multiple of it, so every device gets an equal chunk
    (dynamorph_tpu/seg/inference.py:33-40, :113-123)."""
    n = max(n, n_dev)
    return n - n % n_dev


def zero_pad_rows(x: np.ndarray, n: int) -> np.ndarray:
    """``x`` with zero rows appended up to ``n`` rows, as the JAX package
    pads its batches."""
    if len(x) >= n:
        return x
    return np.concatenate([x, np.zeros((n - len(x),) + x.shape[1:],
                                       x.dtype)])


def map_chunks(fn, model, x: np.ndarray, devices: Sequence[torch.device]
               ) -> np.ndarray:
    """``fn(replica, rows)`` over a host batch fanned out over
    ``devices``: ``x`` (its length a multiple of the device count) split
    into equal chunks in order, chunk i uploaded to ``devices[i]`` and
    handed with ``replica(model, devices[i])`` to ``fn``, every chunk's
    work queued before any result is fetched; the results concatenated in
    order on the host."""
    rows = len(x) // len(devices)
    copies = []
    for i, dev in enumerate(devices):
        with device_scope(dev):
            chunk = upload(x[i * rows:(i + 1) * rows], dev)
            copies.append(HostCopy(fn(replica(model, dev), chunk)))
    return np.concatenate([c.wait() for c in copies])


def batches_over_devices(fn, model, dataset, batch_size: int,
                         devices: Sequence[torch.device]) -> np.ndarray:
    """``fn(replica, rows)`` over a host dataset in batches fanned out over
    several devices: ``batch_size`` raised to the device count and rounded
    down to a multiple of it (dynamorph_tpu/models/resnet_simclr.py:
    213-215), each batch as float32, the last one zero-padded to a
    multiple of the count, and the results in order with the padding
    trimmed (``map_chunks``)."""
    n_dev = len(devices)
    batch_size = round_to_devices(batch_size, n_dev)
    outs = []
    for i in range(0, len(dataset), batch_size):
        batch = np.asarray(dataset[i: i + batch_size], dtype=np.float32)
        padded = zero_pad_rows(batch, pad_to_multiple(len(batch), n_dev))
        outs.append(map_chunks(fn, model, padded, devices)[:len(batch)])
    return np.concatenate(outs)


# The replicas of a model kept on it, one a device, are built under this
# lock: several site workers may ask for the same one at once.
_REPLICA_LOCK = threading.Lock()


def _modules_of(model) -> List[torch.nn.Module]:
    if isinstance(model, torch.nn.Module):
        return [model]
    return [v for v in getattr(model, "__dict__", {}).values()
            if isinstance(v, torch.nn.Module)]


def _indexed(device) -> torch.device:
    """``device`` with its card's index ("cuda" is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def model_device(model) -> Optional[torch.device]:
    """Where a model's weights are: its (or, for a wrapper such as
    ``seg.model.Segment``, its modules') first parameter's or buffer's
    device, else its ``device`` attribute; None for a model with
    neither."""
    for m in _modules_of(model):
        for t in list(m.parameters()) + list(m.buffers()):
            return t.device
    dev = getattr(model, "device", None)
    return None if dev is None else _indexed(dev)


def _weights_version(model) -> tuple:
    """Which tensors the model holds and how often each was written in
    place: a replica made before the model was trained or loaded again
    does not match."""
    return tuple((id(t), t._version) for m in _modules_of(model)
                 for t in list(m.parameters()) + list(m.buffers()))


def _copy_to(model, device: torch.device, cache: dict):
    if isinstance(model, torch.nn.Module):
        # the memo keeps the replica cache itself out of the copy
        return copy.deepcopy(model, {id(cache): {}}).to(device)
    # a wrapper: a shallow copy whose modules are copied to the device
    out = copy.copy(model)
    out.__dict__.pop("_replicas", None)
    for name, v in vars(model).items():
        if isinstance(v, torch.nn.Module):
            setattr(out, name, copy.deepcopy(v).to(device))
    out.device = device
    return out


def replica(model, device):
    """``model`` on ``device``: the model itself where its weights are
    there already (or it has none), else a copy built once a device and
    kept on the model (``_params_on_device``,
    dynamorph_tpu/pipeline/fused.py:125-140), so a plate's sites and
    batches share it. A copy made before the model's weights changed
    (trained, loaded) is made again. A wrapper that is not a
    ``torch.nn.Module`` is copied with its module attributes and its
    ``device`` set."""
    device = _indexed(device)
    home = model_device(model)
    if home is None or home == device:
        return model
    version = _weights_version(model)
    with _REPLICA_LOCK:
        cache = model.__dict__.setdefault("_replicas", {})
        hit = cache.get(device)
        if hit is None or hit[0] != version:
            hit = cache[device] = (version, _copy_to(model, device, cache))
        return hit[1]


def _wire_device(t: torch.Tensor) -> torch.device:
    """Where a collective of the default group takes ``t``: NCCL reduces
    CUDA tensors only, and gloo's CUDA tensors cross through host memory
    here."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str) -> None:
    """Wait for every rank (a no-op outside a process group). ``name``
    labels the wait in the log, as the JAX package's
    ``sync_global_devices(name)`` does."""
    if not is_distributed():
        return
    log.debug("barrier %s", name)
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def allgather_flags(flag: bool) -> List[bool]:
    """Every rank's ``flag``, in rank order (``[flag]`` outside a process
    group): the JAX package's ``process_allgather`` of one bool."""
    if not is_distributed():
        return [bool(flag)]
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    t = t.to(_wire_device(t))
    out = [torch.zeros_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return [bool(v.item()) for v in out]


class ProcessGroupComm:
    """The default process group as a communicator.

    Over gloo, CUDA tensors cross through host memory (a copy each way);
    the computation stays on the card. Over NCCL, CPU tensors cross through
    the rank's card. ``sent_bytes`` counts what ``shift`` sent (the ring's
    traffic)."""

    def __init__(self):
        if not is_distributed():
            raise RuntimeError("ProcessGroupComm needs a process group "
                               "(core.mesh.init_multihost)")
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.backend = dist.get_backend()
        self.sent_bytes = 0

    @property
    def stages_through_host(self) -> bool:
        """True where CUDA tensors cross through host memory (gloo)."""
        return self.backend == "gloo"

    @staticmethod
    def _wire(t: torch.Tensor) -> torch.Tensor:
        return t.contiguous().to(_wire_device(t))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks, as a new tensor on ``t``'s device."""
        w = self._wire(t)
        w = w.clone() if w is t else w
        dist.all_reduce(w)
        return w.to(t.device)

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (equal shapes), in rank order."""
        w = self._wire(t)
        out = [torch.empty_like(w) for _ in range(self.world)]
        dist.all_gather(out, w)
        return [o.to(t.device) for o in out]

    def broadcast(self, t: torch.Tensor, src: int = 0) -> None:
        """Rank ``src``'s ``t`` into ``t`` on every rank, in place."""
        w = self._wire(t)
        dist.broadcast(w, src)
        if w is not t:
            t.copy_(w)

    def shift(self, t: torch.Tensor, steps: int = 1) -> torch.Tensor:
        """Send ``t`` to rank ``(rank + steps) % world`` and return what rank
        ``(rank - steps) % world`` sent: one step of a ring."""
        if self.world == 1:
            return t.clone()
        w = self._wire(t)
        recv = torch.empty_like(w)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, w, (self.rank + steps) % self.world),
            dist.P2POp(dist.irecv, recv, (self.rank - steps) % self.world)])
        for r in reqs:
            r.wait()
        self.sent_bytes += w.numel() * w.element_size()
        return recv.to(t.device)


_scope = threading.local()


def current_comm():
    """The communicator of the data-parallel step on this thread, or
    None."""
    return getattr(_scope, "comm", None)


@contextlib.contextmanager
def collective_scope(comm) -> Iterator[None]:
    """``comm`` is this thread's ``current_comm()`` inside the block (None
    leaves the computation one rank's)."""
    prev = current_comm()
    _scope.comm = comm
    try:
        yield
    finally:
        _scope.comm = prev


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, t):
        ctx.comm = comm
        return comm.all_reduce(t.detach())

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.all_reduce(g)


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, t):
        ctx.comm, ctx.n = comm, t.shape[0]
        return torch.cat(comm.all_gather(t.detach()))

    @staticmethod
    def backward(ctx, g):
        g = ctx.comm.all_reduce(g)
        r, n = ctx.comm.rank, ctx.n
        return None, g[r * n:(r + 1) * n]


class _RingShift(torch.autograd.Function):
    """One step of the ring, whose transpose is the step the other way
    round (JAX's ``ppermute`` and its transpose)."""

    @staticmethod
    def forward(ctx, comm, t):
        ctx.comm = comm
        return comm.shift(t.detach(), 1)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.shift(g, -1)


def all_reduce_sum(t: torch.Tensor, comm=None) -> torch.Tensor:
    """The sum of ``t`` over ranks (``t`` itself without a communicator);
    differentiable."""
    comm = comm if comm is not None else current_comm()
    return t if comm is None else _AllReduceSum.apply(comm, t)


def all_gather_cat(t: torch.Tensor, comm=None) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in rank
    order; differentiable (each rank's slice of the summed gradient flows
    back to it)."""
    comm = comm if comm is not None else current_comm()
    return t if comm is None else _AllGatherCat.apply(comm, t)


def ring_shift(t: torch.Tensor, comm) -> torch.Tensor:
    """What rank ``rank - 1`` holds as ``t``, received while ``t`` goes to
    rank ``rank + 1``; differentiable (the gradient travels back)."""
    return _RingShift.apply(comm, t)


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """A per-rank mean over equal shards as the global batch's mean."""
    comm = current_comm()
    return t if comm is None else all_reduce_sum(t, comm) / comm.world


def global_rows(n: int) -> int:
    """The global batch's size for a shard of ``n`` rows."""
    comm = current_comm()
    return n if comm is None else n * comm.world


def rank_rows(draw: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's equal slice along ``axis`` of a draw made for the global
    batch (every rank draws it from an identically seeded generator)."""
    comm = current_comm()
    if comm is None:
        return draw
    b = draw.shape[axis] // comm.world
    return draw.narrow(axis, comm.rank * b, b)


def average_gradients(params, comm) -> None:
    """Each parameter's gradient averaged over ranks in one all-reduce of
    the flattened gradients (parameters without a gradient, the same on
    every rank, are left out)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    flat /= comm.world
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def broadcast_state(module: torch.nn.Module, comm, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers into ``module`` on every
    rank."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            comm.broadcast(t.data, src)
