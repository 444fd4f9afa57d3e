"""Vector-quantisation codebook lookup.

``vq_lookup`` is the port of ``dynamorph_tpu/ops/vq.py::vq_lookup``: latents
``(..., D)`` go to their nearest codebook rows, ``(q (..., D), idx (...)
int32)``. Distances are ``||E||^2 - 2 z.E^T`` in fp32 (``||z||^2`` is
constant along a row and cannot change the argmin), the first minimum wins,
and ``q = codebook[idx]`` exactly.

- A CUDA tensor launches the hand-written kernel ``csrc/vq_lookup.cu`` (the
  port of the TPU kernel ``_vq_kernel``) or raises: there is no fallback.
- A CPU tensor runs ``vq_lookup_reference``, the plain PyTorch version,
  which is the kernel's specification.

``vq_lookup.launches`` counts kernel launches, so a run can show that it
went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

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
def _kernel():
    """The kernel's C entry point, built at first use, with its signature
    declared (pointers and the stream as c_void_p, ints as c_int)."""
    from ._build import load

    fn = load("vq_lookup").vq_lookup_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _vq_lookup_cuda(z_flat: torch.Tensor, codebook: torch.Tensor):
    _check_cuda_inputs(z_flat, codebook)
    fn = _kernel()
    n, d = z_flat.shape
    q = torch.empty_like(z_flat)
    idx = torch.empty((n,), dtype=torch.int32, device=z_flat.device)
    if n == 0:
        return q, idx
    with torch.cuda.device(z_flat.device):
        stream = torch.cuda.current_stream(z_flat.device).cuda_stream
        err = fn(z_flat.data_ptr(), codebook.data_ptr(), q.data_ptr(),
                 idx.data_ptr(), n, d, codebook.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"vq_lookup kernel launch failed: cudaError {err}")
    vq_lookup.launches += 1
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


def vq_codebook_counts(indices: torch.Tensor,
                       num_embeddings: int) -> torch.Tensor:
    """Histogram of codebook usage (for perplexity monitoring), float32."""
    return torch.bincount(indices.reshape(-1).long(),
                          minlength=num_embeddings).to(torch.float32)


def perplexity_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """exp(entropy) of codebook usage (reference vae.py:66-69 semantics)."""
    probs = counts / torch.clamp(torch.sum(counts), min=1.0)
    return torch.exp(-torch.sum(probs * torch.log(probs + 1e-10)))
