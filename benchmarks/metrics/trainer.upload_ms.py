"""Host ms of the trainer call's resident upload (``train.upload``)."""
from yardstick.spans import upload_ms as read  # noqa: F401
