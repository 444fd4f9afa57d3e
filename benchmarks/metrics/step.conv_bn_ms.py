"""Device ms per training step in cuDNN's convolution and batch-norm
kernels (the epoch's validation steps included)."""
from yardstick.readers import family_ms_per_step


def read(ctx):
    return family_ms_per_step(ctx, ("convolutions (cuDNN)", "batch norm"))
