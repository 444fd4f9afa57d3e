"""Background prefetching of host inputs and background output writes.

The per-well encode loop is device-bound while the NEXT well's pickles sit
unread on disk; `Prefetcher` overlaps that host IO with device compute using
one worker thread, and `AsyncWriter` drains this well's output pickles while
the next well encodes.
"""
from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Tuple, TypeVar

T = TypeVar("T")
R = TypeVar("R")


class Prefetcher:
    """Iterate ``loader(item)`` results with up to ``depth`` loads running
    ahead in background threads. Run-ahead is BOUNDED: at most depth+1 items
    are submitted beyond the last one yielded, so a bounded number of
    results exist at a time. Exceptions surface at the failing item's
    turn."""

    def __init__(self, items: Iterable[T], loader: Callable[[T], R],
                 depth: int = 1):
        self._items = list(items)
        self._loader = loader
        self._depth = max(depth, 1)
        self._pool = ThreadPoolExecutor(max_workers=self._depth)
        self._consumed = False

    def __iter__(self) -> Iterator[Tuple[T, R]]:
        if self._consumed:
            # the pool is shut down after the first pass — a silent second
            # iteration would die deep inside submit with an obscure error
            raise RuntimeError(
                "Prefetcher is single-use; construct a new one per pass")
        self._consumed = True
        pending = deque()
        try:
            for item in self._items:
                pending.append((item, self._pool.submit(self._loader, item)))
                if len(pending) > self._depth:
                    done_item, fut = pending.popleft()
                    yield done_item, fut.result()
            while pending:
                done_item, fut = pending.popleft()
                yield done_item, fut.result()
        finally:
            # cancel queued loads if the consumer abandoned iteration
            self._pool.shutdown(wait=False, cancel_futures=True)

    def __len__(self):
        return len(self._items)


class AsyncWriter:
    """Run host-side output writes (pickle serialization + disk) on one
    background thread so artifact writes overlap device compute.

    At most ``depth`` writes are in flight; ``submit`` blocks beyond that,
    bounding the host memory held by pending outputs. ``close()`` drains the
    queue and re-raises the first failure; use as a context manager so
    errors can't be silently dropped.

    Any number of threads may submit through one writer: ``submit`` and
    ``close`` hold a lock over the pending queue, so each write runs once,
    and one thread's writes run in the order it submitted them.
    """

    def __init__(self, depth: int = 2):
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = deque()
        self._depth = max(depth, 1)
        self._lock = threading.Lock()

    def submit(self, fn: Callable, *args, **kwargs) -> None:
        with self._lock:
            while len(self._pending) >= self._depth:
                self._pending.popleft().result()
            self._pending.append(self._pool.submit(fn, *args, **kwargs))

    def close(self) -> None:
        try:
            with self._lock:
                while self._pending:
                    self._pending.popleft().result()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self._pool.shutdown(wait=False)
        return False
