"""Training patches stepped per second over the window: whole epochs of
the trainer, validation passes, the per-epoch sync and checkpoints
included."""
from yardstick.readers import rate as read  # noqa: F401
