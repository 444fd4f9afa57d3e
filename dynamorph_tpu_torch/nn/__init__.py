"""Layers come from ``torch.nn``; ``functional`` holds the JAX-to-torch
weight layout converters, and ``batchnorm`` the batch norm over a
data-parallel step's global batch and ``BatchNorm2d``, torch's with a
following ReLU folded in and its training pass on the port's kernels."""
