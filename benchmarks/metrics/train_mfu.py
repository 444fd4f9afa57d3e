"""% of the card's fp32 peak (67 TFLOP/s) that the model's operations reach
over the traced window."""
from yardstick.readers import mfu as read  # noqa: F401
