"""Layers come from ``torch.nn``; ``functional`` holds the JAX-to-torch
weight layout converters, and ``batchnorm`` the batch norm over a
data-parallel step's global batch."""
