"""Async admission queue + micro-batcher.

Requests carry variable-length uint64 key arrays.  Admission is
continuous (callers never block on submit) and flushing is governed by
the two classic triggers of a serving micro-batcher:

  size      pending keys reached ``max_batch`` — flush immediately;
  deadline  the OLDEST pending request has waited ``deadline_s`` — flush
            whatever is pending, however small.

``take()`` drains whole requests in admission order, so completion is
FIFO per client by construction: a request's future can only resolve
after every earlier request's future (batches are dispatched by a single
flusher, in take order).  A request larger than ``max_batch`` is not
split — it forms an oversize batch on its own; the dispatcher pads to a
power-of-two bucket anyway, so the compile-cache cost is the same.

Fairness (optional): with ``max_client_keys`` set, a client that passes
its id to ``submit`` may hold at most that many pending keys — the
(minimal) defense against one client monopolizing every flush window.
``client_rate=(rate, burst)`` adds a per-client token bucket on top:
each client's bucket refills at ``rate`` keys/second up to ``burst``
tokens, and a submit needing more tokens than the bucket holds is
rejected.  Both defenses raise `ClientBacklogFull` immediately
(backpressure at admission, the cheapest point); the strict-FIFO
default behavior is unchanged when unset or the client anonymous.

Requests carry a ``kind`` tag ("read" by default); scans ride the same
queue with ``kind="scan"`` (``aux`` = scan length) and the mutable
service admits inserts with ``kind="insert"``, so reads, scans, and
writes share one admission order — the property the oracle-replay
invariant is stated against.

Latency classes: requests also carry a
``priority`` class with a per-class deadline budget
(``class_deadlines={"interactive": 0.002, "batch": 0.05}``).  The
deadline trigger fires at the EARLIEST ``t_submit + deadline(class)``
over everything pending, so an interactive request landing behind
queued batch traffic still bounds its own wait — batch requests merely
stop forcing eager tiny flushes.  Admission order (and therefore FIFO
completion) is unchanged: classes shape WHEN a flush happens, never
reorder requests within it.  Unknown classes fall back to the default
``deadline_s``, and with ``class_deadlines`` unset the behavior is
exactly the classic single-deadline batcher.

Host-only: a copy of the reference's `repro.serve.lookup.admission`
(whose package imports JAX), held to its behaviour by
`tests/test_torch_serve_lookup.py`.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serve.common import MonotonicCounter


class ClientBacklogFull(RuntimeError):
    """Raised at submit() when a client exceeds its pending-key cap."""


class LookupFuture:
    """Per-request completion handle (stdlib-free, two-method surface)."""

    def __init__(self, rid: int, n_keys: int):
        self.rid = rid
        self.n_keys = n_keys
        self._event = threading.Event()
        self._result: Optional[np.ndarray] = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError(f"lookup rid={self.rid} not done")
        if self._exc is not None:
            raise self._exc
        return self._result

    # -- producer side (service internals only) -------------------------
    def _set_result(self, value: np.ndarray) -> None:
        self._result = value
        self._event.set()

    def _set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()


@dataclasses.dataclass
class PendingRequest:
    rid: int
    keys: np.ndarray          # 1-D uint64
    future: LookupFuture
    t_submit: float           # perf_counter at admission
    kind: str = "read"        # "read" | "scan" | "insert" (mutable service)
    aux: int = 0              # scan length for kind="scan", else 0
    client: Optional[object] = None   # fairness-cap accounting id
    #: Admission-time shard routing: ``(topology, shard
    #: id per key)`` when a router is installed.  Dispatch consumes it
    #: only if the topology object is IDENTICAL to the pinned one — a
    #: hot-swap in between invalidates the tag and dispatch re-routes.
    route: Optional[tuple] = None
    #: Latency class: picks the deadline budget at admission and the
    #: per-class latency accounting in `ServiceMetrics`.
    priority: str = "interactive"


class MicroBatcher:
    """Thread-safe admission queue with size/deadline flush policy."""

    def __init__(self, max_batch: int, deadline_s: float,
                 counter: Optional[MonotonicCounter] = None,
                 max_client_keys: Optional[int] = None,
                 client_rate: Optional[Tuple[float, float]] = None,
                 recorder=None,
                 class_deadlines: Optional[dict] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_client_keys is not None and max_client_keys < 1:
            raise ValueError("max_client_keys must be >= 1")
        if client_rate is not None:
            rate, burst = client_rate
            if rate <= 0 or burst < 1:
                raise ValueError("client_rate needs rate > 0 and burst >= 1")
            client_rate = (float(rate), float(burst))
        if class_deadlines is not None:
            class_deadlines = {str(k): float(v)
                               for k, v in class_deadlines.items()}
            if any(v <= 0 for v in class_deadlines.values()):
                raise ValueError("class deadlines must be > 0 seconds")
        self.max_batch = int(max_batch)
        self.deadline_s = float(deadline_s)
        self.class_deadlines = class_deadlines
        self.max_client_keys = max_client_keys
        self.client_rate = client_rate
        #: optional `repro_torch.obs.trace.SpanRecorder`: admission instants
        #: (one per rid — the trace's request-id origin) and rejections
        self.recorder = recorder
        self._counter = counter if counter is not None else MonotonicCounter()
        #: Optional routing hook ``keys -> (topology, shard ids)`` run at
        #: admission (outside the condition lock) — the vectorized route
        #: step of the range-routed topology.  Installed/cleared by the
        #: service's publish hook; best-effort: a failing router admits
        #: the request untagged and dispatch routes it itself.
        self.router = None
        self._pending: "collections.deque[PendingRequest]" = collections.deque()
        self._n_keys = 0
        #: earliest (t_submit + class deadline) over pending requests —
        #: maintained incrementally on submit, recomputed on take; with
        #: no class map this is always the head's deadline (FIFO submit
        #: times are monotone), i.e. the classic behavior.
        self._next_deadline = float("inf")
        self._client_keys: dict = {}
        self._buckets: dict = {}   # client -> (tokens, last_refill_t)
        self._cond = threading.Condition()

    # -- admission -------------------------------------------------------
    def _check_rate_locked(self, client, n_keys: int, now: float) -> None:
        """Token bucket: refill, then spend ``n_keys`` or reject.  Burst
        bounds the instantaneous spike; rate the sustained key/s."""
        rate, burst = self.client_rate
        tokens, last = self._buckets.get(client, (burst, now))
        tokens = min(burst, tokens + (now - last) * rate)
        if n_keys > tokens:
            self._buckets[client] = (tokens, now)
            raise ClientBacklogFull(
                f"client {client!r} rate-limited: {n_keys} keys > "
                f"{tokens:.1f} tokens (rate={rate}/s, burst={burst:.0f})")
        self._buckets[client] = (tokens - n_keys, now)

    def deadline_for(self, priority: str) -> float:
        """The flush budget of one latency class (falls back to the
        default ``deadline_s`` for unknown classes)."""
        if self.class_deadlines is None:
            return self.deadline_s
        return self.class_deadlines.get(priority, self.deadline_s)

    def submit(self, keys, kind: str = "read", aux: int = 0,
               client=None,
               priority: str = "interactive") -> Tuple[int, LookupFuture]:
        # Always copy: the request may sit queued for deadline_s, and a
        # client reusing its buffer must not mutate keys already admitted.
        keys = np.array(keys, dtype=np.uint64, copy=True).ravel()
        if keys.size == 0:
            raise ValueError("empty key array")
        rid = self._counter.next()
        fut = LookupFuture(rid, keys.size)
        req = PendingRequest(rid, keys, fut, time.perf_counter(),
                             kind=kind, aux=int(aux), client=client,
                             priority=str(priority))
        router = self.router
        if router is not None and kind != "insert":
            try:
                req.route = router(keys)
            except Exception:   # noqa: BLE001 — routing is best-effort here
                req.route = None
        try:
            with self._cond:
                if client is not None:
                    # backlog cap first (checks without consuming), then the
                    # token bucket (consumes) — a cap rejection must not burn
                    # tokens, and a rate rejection must not count as backlog.
                    if self.max_client_keys is not None:
                        held = self._client_keys.get(client, 0)
                        if held + keys.size > self.max_client_keys:
                            raise ClientBacklogFull(
                                f"client {client!r} holds {held} pending keys; "
                                f"+{keys.size} exceeds cap {self.max_client_keys}")
                    if self.client_rate is not None:
                        # timestamp read INSIDE the lock: refills stay monotone
                        # under concurrent submits of the same client
                        self._check_rate_locked(client, keys.size,
                                                time.perf_counter())
                    if self.max_client_keys is not None:
                        self._client_keys[client] = (
                            self._client_keys.get(client, 0) + keys.size)
                self._pending.append(req)
                self._n_keys += keys.size
                self._next_deadline = min(
                    self._next_deadline,
                    req.t_submit + self.deadline_for(req.priority))
                self._cond.notify_all()
        except ClientBacklogFull:
            if self.recorder is not None:
                self.recorder.instant("admission_rejected", cat="admission",
                                      rid=rid, kind=kind,
                                      n_keys=int(keys.size))
            raise
        if self.recorder is not None:
            # outside the condition lock: tracing must not stretch the
            # admission critical section every submitter contends on
            self.recorder.instant("admit", cat="admission", t=req.t_submit,
                                  rid=rid, kind=kind, n_keys=int(keys.size))
        return rid, fut

    def pending_keys_of(self, client) -> int:
        with self._cond:
            return self._client_keys.get(client, 0)

    # -- introspection ---------------------------------------------------
    @property
    def pending_keys(self) -> int:
        with self._cond:
            return self._n_keys

    @property
    def pending_requests(self) -> int:
        with self._cond:
            return len(self._pending)

    # -- flush policy ----------------------------------------------------
    def _ready_locked(self, now: float) -> bool:
        if not self._pending:
            return False
        if self._n_keys >= self.max_batch:
            return True
        return now >= self._next_deadline

    def ready(self) -> bool:
        with self._cond:
            return self._ready_locked(time.perf_counter())

    def wait_ready(self, timeout: Optional[float] = None,
                   until=None) -> bool:
        """Block until a flush is due (size OR deadline) or `timeout`.

        ``until`` is an optional predicate checked on every wake-up:
        when it turns true the wait returns False immediately — paired
        with `wake()`, a flusher can wait with no timeout at all and
        still shut down promptly (no polling loop)."""
        t_end = None if timeout is None else time.perf_counter() + timeout
        with self._cond:
            while True:
                if until is not None and until():
                    return False
                now = time.perf_counter()
                if self._ready_locked(now):
                    return True
                # sleep until the earliest pending class deadline or the
                # caller's timeout, whichever is sooner; a submit()
                # notify wakes us early to re-check the size trigger (or
                # a tighter deadline a new request just introduced).
                waits = []
                if self._pending:
                    waits.append(self._next_deadline - now)
                if t_end is not None:
                    if now >= t_end:
                        return False
                    waits.append(t_end - now)
                self._cond.wait(timeout=min(waits) if waits else None)

    def wake(self) -> None:
        """Nudge every `wait_ready` waiter to re-check its ``until``
        predicate (shutdown signal — state here does not change)."""
        with self._cond:
            self._cond.notify_all()

    def take(self, force: bool = False) -> List[PendingRequest]:
        """Drain whole requests, in order, up to ``max_batch`` keys.

        Returns [] when no flush is due (unless ``force``).  Always takes
        at least one request when it takes anything, so an oversize
        request cannot deadlock the queue.
        """
        with self._cond:
            if not self._pending:
                return []
            if not force and not self._ready_locked(time.perf_counter()):
                return []
            out: List[PendingRequest] = []
            taken = 0
            while self._pending:
                nxt = self._pending[0]
                if out and taken + nxt.keys.size > self.max_batch:
                    break
                out.append(self._pending.popleft())
                taken += nxt.keys.size
            self._n_keys -= taken
            self._next_deadline = min(
                (r.t_submit + self.deadline_for(r.priority)
                 for r in self._pending), default=float("inf"))
            for r in out:
                if r.client is not None and r.client in self._client_keys:
                    left = self._client_keys[r.client] - r.keys.size
                    if left > 0:
                        self._client_keys[r.client] = left
                    else:
                        del self._client_keys[r.client]
            # prune refilled-to-burst buckets: a full bucket is identical
            # to no bucket, and ephemeral client ids must not leak memory
            if self.client_rate is not None and self._buckets:
                rate, burst = self.client_rate
                now = time.perf_counter()
                for c in [c for c, (tok, last) in self._buckets.items()
                          if tok + (now - last) * rate >= burst]:
                    del self._buckets[c]
            return out
