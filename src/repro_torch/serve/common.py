"""Small shared primitives for the serving layer.

`MonotonicCounter` is the one source of request ids: ids must never be
reused while any holder can still reference them.  A counter is
trivially unique and, being monotonic, also gives a free happens-before
order for FIFO assertions in tests.  A copy of the reference's
`repro.serve.common`.
"""
from __future__ import annotations

import itertools
import threading


class MonotonicCounter:
    """Thread-safe monotonically increasing id source.

    `itertools.count.__next__` is atomic under CPython's GIL, but the
    lock keeps the invariant explicit (and true on GIL-free builds).
    """

    def __init__(self, start: int = 0):
        self._it = itertools.count(start)
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            return next(self._it)
