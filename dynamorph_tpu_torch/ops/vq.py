"""Vector-quantisation codebook search (the port of
``dynamorph_tpu/ops/vq.py``).

- ``vq_lookup``: latents ``(..., D)`` go to their nearest codebook rows,
  ``(q (..., D), idx (...) int32)``, with ``q = codebook[idx]`` exactly. The
  encode path and the eval steps use it.
- ``vq_indices``: the same search, indices only. The training path uses it
  and re-gathers the rows with ``gather_codes``, whose gradient reaches the
  codebook.

Distances are ``||E||^2 - 2 z.E^T`` in fp32 (``||z||^2`` is constant along a
row and cannot change the argmin) and the first minimum wins.

- A CUDA tensor launches a hand-written kernel of ``csrc/vq_lookup.cu``
  (the ports of the TPU kernels ``_vq_kernel`` and ``_vq_kernel_idx``) or
  raises: there is no fallback.
- A CPU tensor runs ``vq_lookup_reference`` or ``vq_indices_reference``, the
  plain PyTorch versions, which are the kernels' specification.

``vq_lookup.launches`` and ``vq_indices.launches`` count kernel launches, so
a run can show that it went through the kernels.

``_vq_lookup_rowwise_cuda`` launches the lookup's first, one-thread-a-row
kernel: a test oracle for the tiled one (the same fp32 chains in another
loop structure), which nothing in the package calls and no counter counts.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..core.device import fp32_strict

# Latent widths the kernel is instantiated for (csrc/vq_lookup.cu): those
# of the models' configs, 16 (z16) and 64 (z32).
KERNEL_DIMS = (16, 64)


def vq_lookup_reference(z_flat: torch.Tensor, codebook: torch.Tensor):
    """Plain version: z_flat (N, D), codebook (K, D) -> (q (N, D),
    idx (N,) int32). The kernel's own formula (``_vq_kernel``,
    dynamorph_tpu/ops/vq.py:68-89) in fp32; ``torch.argmin`` returns the
    first minimum."""
    e2 = torch.sum(codebook * codebook, dim=-1)
    dist = e2[None, :] - 2.0 * (z_flat @ codebook.T)
    idx = torch.argmin(dist, dim=-1)
    return codebook[idx], idx.to(torch.int32)


def _check_cuda_inputs(z_flat: torch.Tensor, codebook: torch.Tensor) -> None:
    for name, t in (("z", z_flat), ("codebook", codebook)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if z_flat.device != codebook.device:
        raise ValueError(f"z on {z_flat.device} but codebook on "
                         f"{codebook.device}")
    if z_flat.dim() != 2 or codebook.dim() != 2 or \
            z_flat.shape[1] != codebook.shape[1]:
        raise ValueError(f"shapes z {tuple(z_flat.shape)} and codebook "
                         f"{tuple(codebook.shape)} do not match (N, D), (K, D)")
    if codebook.shape[1] not in KERNEL_DIMS:
        raise ValueError(f"latent width {codebook.shape[1]} not in the "
                         f"kernel's widths {KERNEL_DIMS}")
    if codebook.shape[0] < 1:
        raise ValueError("codebook is empty")
    if z_flat.shape[0] >= 2 ** 31 or codebook.shape[0] >= 2 ** 31:
        raise ValueError("N and K must be below 2**31")


@functools.cache
def _kernel(entry: str = "vq_lookup_f32"):
    """A C entry point of ``csrc/vq_lookup.cu``, built at first use, with its
    signature declared (pointers and the stream as c_void_p, ints as
    c_int)."""
    from ._build import load

    n_ptrs = {"vq_lookup_f32": 4, "vq_lookup_rowwise_f32": 4,
              "vq_indices_f32": 3}[entry]
    fn = getattr(load("vq_lookup"), entry)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_lookup(entry: str, z_flat: torch.Tensor, codebook: torch.Tensor):
    """(q, idx, launched) from the lookup kernel behind the C entry
    ``entry``; nothing is launched where N is 0."""
    _check_cuda_inputs(z_flat, codebook)
    fn = _kernel(entry)
    n, d = z_flat.shape
    q = torch.empty_like(z_flat)
    idx = torch.empty((n,), dtype=torch.int32, device=z_flat.device)
    if n == 0:
        return q, idx, False
    with torch.cuda.device(z_flat.device):
        stream = torch.cuda.current_stream(z_flat.device).cuda_stream
        err = fn(z_flat.data_ptr(), codebook.data_ptr(), q.data_ptr(),
                 idx.data_ptr(), n, d, codebook.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    return q, idx, True


def _vq_lookup_cuda(z_flat: torch.Tensor, codebook: torch.Tensor):
    q, idx, launched = _launch_lookup("vq_lookup_f32", z_flat, codebook)
    vq_lookup.launches += launched
    vq_lookup.launches_by_device[str(z_flat.device)] += launched
    return q, idx


def _vq_lookup_rowwise_cuda(z_flat: torch.Tensor, codebook: torch.Tensor):
    """The row-wise test oracle of the lookup kernel: (q, idx) bit-equal to
    ``_vq_lookup_cuda``'s. Not counted, and called by no path of the
    package (tests and chip_smoke.py only)."""
    q, idx, _ = _launch_lookup("vq_lookup_rowwise_f32", z_flat, codebook)
    return q, idx


def vq_lookup(z: torch.Tensor, codebook: torch.Tensor):
    """Nearest-codebook lookup.

    Args:
        z: latents, (..., D) — any leading shape (e.g. (B, H, W, D)).
        codebook: (K, D) embedding table.

    Returns:
        (quantized (..., D), indices (...,) int32)
    """
    lead = z.shape[:-1]
    d = z.shape[-1]
    z_flat = z.reshape(-1, d)
    if z.is_cuda:
        q, idx = _vq_lookup_cuda(z_flat.contiguous(), codebook.contiguous())
    elif z.device.type == "cpu" and codebook.device.type == "cpu":
        q, idx = vq_lookup_reference(z_flat, codebook)
    else:
        raise ValueError(f"vq_lookup: z on {z.device}, codebook on "
                         f"{codebook.device}")
    return q.reshape(*lead, d), idx.reshape(lead)


vq_lookup.launches = 0
# the same launches by the device they ran on ("cuda:0", ...)
vq_lookup.launches_by_device = collections.Counter()

# The JAX package's precision strings for the training-path distances, and
# what each computes here. On the TPU they pick the MXU passes of the
# distance matmul ("high", its default, went to XLA at 3-pass bf16). The
# hand-written kernel serves all three in IEEE fp32 FMAs, at least as exact
# as HIGHEST, so it meets the JAX package's gate for "high" (at most 0.006%
# of assignments flipped against float64).
PRECISIONS = {"default": "fp32", "high": "fp32", "highest": "fp32"}


def vq_indices_reference(z_flat: torch.Tensor,
                         codebook: torch.Tensor) -> torch.Tensor:
    """Plain version: z_flat (N, D), codebook (K, D) -> idx (N,) int32. The
    TPU kernel's formula (``_vq_kernel_idx``, dynamorph_tpu/ops/vq.py:152-164)
    in fp32; ``torch.argmin`` returns the first minimum."""
    e2 = torch.sum(codebook * codebook, dim=-1)
    dist = e2[None, :] - 2.0 * (z_flat @ codebook.T)
    return torch.argmin(dist, dim=-1).to(torch.int32)


def _vq_indices_cuda(z_flat: torch.Tensor,
                     codebook: torch.Tensor) -> torch.Tensor:
    _check_cuda_inputs(z_flat, codebook)
    fn = _kernel("vq_indices_f32")
    n, d = z_flat.shape
    idx = torch.empty((n,), dtype=torch.int32, device=z_flat.device)
    if n == 0:
        return idx
    with torch.cuda.device(z_flat.device):
        stream = torch.cuda.current_stream(z_flat.device).cuda_stream
        err = fn(z_flat.data_ptr(), codebook.data_ptr(), idx.data_ptr(), n,
                 d, codebook.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"vq_indices kernel launch failed: cudaError {err}")
    vq_indices.launches += 1
    return idx


def vq_indices(z: torch.Tensor, codebook: torch.Tensor,
               precision: str = "highest") -> torch.Tensor:
    """Nearest-codebook INDICES only: the search of ``vq_lookup`` without
    the quantized rows. No gradient flows through it.

    Args:
        z: latents, (..., D).
        codebook: (K, D) embedding table.
        precision: a key of ``PRECISIONS``; every one computes in fp32.

    Returns:
        indices (...,) int32
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in "
                         f"{sorted(PRECISIONS)}")
    lead = z.shape[:-1]
    z_flat = z.detach().reshape(-1, z.shape[-1])
    codebook = codebook.detach()
    if z.is_cuda:
        idx = _vq_indices_cuda(z_flat.contiguous(), codebook.contiguous())
    elif z.device.type == "cpu" and codebook.device.type == "cpu":
        idx = vq_indices_reference(z_flat, codebook)
    else:
        raise ValueError(f"vq_indices: z on {z.device}, codebook on "
                         f"{codebook.device}")
    return idx.reshape(lead)


vq_indices.launches = 0


def gather_codes_grad(indices: torch.Tensor, ct: torch.Tensor,
                      num_embeddings: int) -> torch.Tensor:
    """The codebook gradient of ``gather_codes``: ``onehot(idx)^T @ ct`` in
    fp32, (K, D). A matrix product has a fixed summation order, so the
    result is the same in every run, where ``index_add_`` (the backward of
    ``index_select``) sums with atomics on CUDA. The (N, K) one-hot is freed
    on return (1.6 GB at the z32 training shape)."""
    d = ct.shape[-1]
    idx = indices.reshape(-1, 1).long()
    with fp32_strict():
        # one 1 per row, so the scatter has no colliding writes
        onehot = torch.zeros((idx.shape[0], num_embeddings), dtype=ct.dtype,
                             device=ct.device).scatter_(1, idx, 1.0)
        return onehot.T @ ct.reshape(-1, d)


class _GatherCodes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, codebook, indices):
        ctx.save_for_backward(indices)
        ctx.num_embeddings = codebook.shape[0]
        rows = torch.index_select(codebook, 0, indices.reshape(-1).long())
        return rows.reshape(*indices.shape, codebook.shape[1])

    @staticmethod
    def backward(ctx, ct):
        (indices,) = ctx.saved_tensors
        return gather_codes_grad(indices, ct, ctx.num_embeddings), None


def gather_codes(codebook: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Differentiable codebook row gather: (K, D), (...) -> (..., D)
    (``dynamorph_tpu/ops/vq.py:255-284``). The forward is a row gather; the
    backward is ``gather_codes_grad``."""
    return _GatherCodes.apply(codebook, indices)


def vq_codebook_counts(indices: torch.Tensor,
                       num_embeddings: int) -> torch.Tensor:
    """Histogram of codebook usage (for perplexity monitoring), float32."""
    return torch.bincount(indices.reshape(-1).long(),
                          minlength=num_embeddings).to(torch.float32)


def perplexity_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """exp(entropy) of codebook usage (reference vae.py:66-69 semantics)."""
    probs = counts / torch.clamp(torch.sum(counts), min=1.0)
    return torch.exp(-torch.sum(probs * torch.log(probs + 1e-10)))
