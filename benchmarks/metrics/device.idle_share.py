"""% of the traced window in which no operation ran on the card."""
from yardstick.readers import idle_share as read  # noqa: F401
