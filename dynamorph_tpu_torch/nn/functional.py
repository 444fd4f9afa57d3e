"""Weight layout converters from the JAX package's conventions to torch's.

The port's layers are ``torch.nn`` layers (``Conv2d``, ``ConvTranspose2d``,
``BatchNorm2d`` with eps 1e-5 and momentum 0.1, the values the JAX package
uses); only the weight layouts differ:

- conv kernels: JAX HWIO ``(kh, kw, in, out)`` -> torch OIHW.
- conv-transpose kernels: JAX ``(kh, kw, in, out)`` -> torch
  ``(in, out, kh, kw)``. The JAX layer flips the kernel spatially in its
  forward pass (an input-dilated conv with the flipped kernel);
  ``torch.nn.ConvTranspose2d`` computes the same adjoint natively, so the
  weight crosses with the axis permutation alone.
"""
from __future__ import annotations

import numpy as np


def conv_kernel_to_torch(w: np.ndarray) -> np.ndarray:
    """JAX conv kernel HWIO -> torch Conv2d weight OIHW."""
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def conv_transpose_kernel_to_torch(w: np.ndarray) -> np.ndarray:
    """JAX conv-transpose kernel (kh, kw, in, out) -> torch ConvTranspose2d
    weight (in, out, kh, kw)."""
    return np.transpose(np.asarray(w), (2, 3, 0, 1))
