"""Ops with a hand-written CUDA kernel (``csrc/``) and a plain PyTorch
version beside each."""
