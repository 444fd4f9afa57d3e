"""Layers come from ``torch.nn``; ``functional`` holds the JAX-to-torch
weight layout converters."""
