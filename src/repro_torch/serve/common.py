"""Small shared primitives for the serving layer.

`MonotonicCounter` is the one source of request ids: ids must never be
reused while any holder can still reference them.  A counter is
trivially unique and, being monotonic, also gives a free happens-before
order for FIFO assertions in tests.  The reference's
`repro.serve.common`, plus `advance_past` for a registry that publishes a
generation made elsewhere.
"""
from __future__ import annotations

import threading


class MonotonicCounter:
    """Thread-safe monotonically increasing id source."""

    def __init__(self, start: int = 0):
        self._next = int(start)
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            v = self._next
            self._next += 1
            return v

    def advance_past(self, value: int) -> None:
        """Make every later id greater than ``value``."""
        with self._lock:
            self._next = max(self._next, int(value) + 1)
