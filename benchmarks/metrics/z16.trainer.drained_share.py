"""% of the window's trainer call spent on host work with the card drained
(``train.drained`` over ``train.call``)."""
from yardstick.spans import drained_share as read  # noqa: F401
