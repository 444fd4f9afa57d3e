"""Training patches stepped per second over the window, for the z16 cell:
whole epochs of the trainer, validation passes, the per-epoch sync and
checkpoints included. Its own name because the z16 step is partly paced
by the host, and its spread must not set the card-paced cells' bound."""
from yardstick.readers import rate as read  # noqa: F401
