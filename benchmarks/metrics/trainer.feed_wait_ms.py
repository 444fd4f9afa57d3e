"""Host ms a step that the trainer waited on its prefetch thread
(``train.feed_wait`` over the training and validation steps)."""
from yardstick.spans import feed_wait_ms as read  # noqa: F401
