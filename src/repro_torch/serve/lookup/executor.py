"""Continuous-batching async executor + executable cache.

The synchronous dispatch path (`LookupService._dispatch_once`) is serial
batch-at-a-time: take a batch, launch, wait for the device, complete
futures, only then admit the next batch.  This module rebuilds the path
the way inference servers do:

  executable cache   `ExecutableCache` maps ``(context key, kind, aux,
                     batch bucket, device)`` to a ready-to-run executable.
                     On a CUDA device a plan's callable is captured as a
                     CUDA graph for the bucket (`GraphExecutable`): the
                     dozens of launches of an instrumented read (predict,
                     kernel, health reductions) become one replay.  On the
                     CPU, and for a callable that did not come from a plan,
                     the callable runs as it is.  Warm-up builds the
                     common buckets at `start()` and again after every
                     hot swap (`IndexRegistry` publish subscription), off
                     the dispatch thread.

  double buffering   the DISPATCH thread takes a batch, pins its context,
                     stages it, and LAUNCHES the device step on the
                     executor's own stream of each card (one
                     high-priority stream a card), with the copy of the
                     outputs into its slot's pinned host buffers and an
                     event behind it, without waiting; the COMPLETION
                     thread waits on those events and resolves futures.
                     Admission and host-side completion of batch N
                     overlap the device work of batch N+1.

  slot ring          launched batches ride a bounded FIFO ring of
                     in-flight slots.  Admission (`submit`) never blocks;
                     the dispatch thread only waits when the ring is full.
                     Completing slots strictly in ring order preserves the
                     admission order, hence per-client FIFO completion.

Every result is bit-identical to the synchronous path: both run the same
plan callables (the graph replays exactly the kernels the callable
launches) over the same padded buckets.

Graph capture: each capture runs on a side stream of the building thread
with ``capture_error_mode="thread_local"``, so the dispatch thread keeps
launching, waiting on events and allocating pinned memory while a
re-warm captures after a publish; captures themselves are serialized by
one lock, which also attributes each graph's kernel launches.  An eager
run precedes each capture (the kernels' libraries, the allocator and any
state a callable makes on first use exist before capture), and one
replay follows it, synchronized, before the graph enters the cache: a
graph is never replayed by two threads at once.  Garbage collection is
off during a capture (a collection that freed a graph or a buffer on the
capturing thread would end it), and graphs hold their replay accounting
(`GraphStats`), not their cache, so an evicted graph is freed by its
last holder, not by a collection.  A capture that fails raises; nothing
falls back to eager launches.  The kernel wrappers count
a launch when it is captured, not when it is replayed, so the cache
counts each graph's replays and the launches it captured.

Several cards: a broadcast batch pins one `AsyncContext` a slice of the
data axis (a tuple, one per dispatcher device, each over its device's
replica) and launches one executable a slice on that slice's card
(`dispatch.ShardedDispatcher.launch`), each into a pinned host set of its
own.  Routed batches: a `RoutedContext` launches one graph replay per
shard lane the batch touches (`dispatch.RoutedDispatcher.launch`), each
into a pinned host set of its own.  Either way the batch rides the ring
as one slot that keeps every card's executable and the context (every
replica, shard generation and scan head) until it completes: a swap never
frees memory a queued replay on any card still reads.  A graph is
captured and replayed under its own card (`torch.cuda.device`), whatever
the calling thread's current device.

A port of the reference's `repro.serve.lookup.executor`.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import encode_keys
from repro_torch.obs.trace import maybe_span
from repro_torch.serve.lookup.dispatch import (RoutedContext, device_guard,
                                               distinct)

__all__ = ["AsyncContext", "AsyncExecutor", "ExecutableCache",
           "GraphExecutable", "GraphStats", "WorkItem",
           "kernel_launch_counts"]


@dataclasses.dataclass(frozen=True)
class AsyncContext:
    """One pinned lookup context, executable-cache addressable.

    ``key`` namespaces the cache: everything the executable depends on
    beyond the batch shape: the generation version (and, for merged
    mutable views, the padded delta length).  ``bind`` holds extra device
    operands appended after the query batch (the padded delta for merged
    lookups); they vary per view without invalidating the cached
    executable, which is why the merged fn takes the delta as an
    ARGUMENT, not a closure.
    """

    key: Tuple                 # hashable; key[0] is the generation version
    read_fn: Callable          # (q, *bind) -> positions
    scan_fn: Callable          # m -> ((q, *bind) -> (positions, window))
    bind: Tuple = ()           # device operands appended after q
    sample_key: int = 1        # a valid key for warm-up dummy batches
    #: When set, ``read_fn`` is the plan's instrumented lookup ``(q,
    #: n_valid, *bind) -> (pos, stats)``: reads pass the real batch size
    #: and completion strips the stats off for the health monitor.
    instrumented: bool = False


@dataclasses.dataclass
class WorkItem:
    """One dispatchable unit: a same-kind request group + how to run it."""

    kind: str                           # "read" | "scan" | "insert"
    group: List                         # PendingRequests, admission order
    #: device kinds only: one AsyncContext a slice (a tuple), or a
    #: RoutedContext
    ctx: Any = None
    aux: int = 0                        # scan length for kind="scan"
    apply_fn: Optional[Callable] = None  # host op (inserts): group -> array


@dataclasses.dataclass
class _Slot:
    """One in-flight ring entry.  Exactly one of (out, host, error) is
    meaningful: a launched batch, a host-side result that is already
    final (inserts), or a launch failure to propagate."""

    group: List
    kind: str
    out: Any = None              # dispatch.Launched (_RoutedHandle if routed)
    exe: Any = None              # the executable(s), kept alive until done
    ctx: Any = None              # the pinned context (its bind), likewise
    hosts: List = dataclasses.field(default_factory=list)  # pinned sets
    m: int = 0                   # real key count (pre-padding)
    padded: int = 0
    host: Any = None             # host-ready result (inserts)
    error: Optional[BaseException] = None
    t_submit_oldest: float = 0.0
    t_launch: float = 0.0
    is_insert: bool = False
    version: int = -1            # generation the stats (if any) belong to
    instrumented: bool = False   # out is (payload, packed health stats)
    routed: bool = False         # out is a dispatch._RoutedHandle


_STOP = object()

#: serializes captures (and the eager run before each) across threads,
#: so the launch counts read around a capture are that graph's own
_CAPTURE_LOCK = threading.Lock()


def kernel_launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counts, by kernel name (every card's;
    each wrapper's ``by_device`` splits its count by card)."""
    from repro_torch.kernels.bounded_search import kernel as bs_kernel
    from repro_torch.kernels.pgm_lookup import kernel as pgm_kernel
    from repro_torch.kernels.rmi_lookup import kernel as rmi_kernel

    return {"rmi_lookup": rmi_kernel.launch_lookup.launches,
            "rmi_bounds": rmi_kernel.launch_bounds.launches,
            "bounded_search": bs_kernel.launch.launches,
            "pgm_lookup": pgm_kernel.launch_lookup.launches}


class GraphStats:
    """Replay accounting shared by a cache and the graphs it built: graphs
    built, their serving replays, the one checking replay each build
    makes, and the kernel launches all those replays made (each graph's
    captured launches times its replays).  A graph holds this, not its
    cache, so a cache and its graphs form no reference cycle: an evicted
    graph is freed when its last holder lets go of it, never by a garbage
    collection that could run in the middle of another capture."""

    def __init__(self):
        self._mu = threading.Lock()
        self.graphs_built = 0
        self.graph_replays = 0
        self.warm_replays = 0
        self.kernel_launches: Dict[str, int] = {}
        #: the same launches by card: device name -> kernel -> launches
        self.kernel_launches_by_device: Dict[str, Dict[str, int]] = {}

    def note(self, exe: "GraphExecutable", warm: bool) -> None:
        with self._mu:
            if warm:
                self.graphs_built += 1
                self.warm_replays += 1
            else:
                self.graph_replays += 1
            per = self.kernel_launches_by_device.setdefault(
                str(exe.device), {})
            for k, c in exe.captured.items():
                self.kernel_launches[k] = self.kernel_launches.get(k, 0) + c
                per[k] = per.get(k, 0) + c

    def snapshot(self) -> Dict[str, Any]:
        with self._mu:
            return {"graphs_built": self.graphs_built,
                    "graph_replays": self.graph_replays,
                    "warm_replays": self.warm_replays,
                    "kernel_launches": dict(self.kernel_launches)}

    def by_device(self) -> Dict[str, Dict[str, int]]:
        """The replays' kernel launches by card: device name -> kernel ->
        launches."""
        with self._mu:
            return {d: dict(v)
                    for d, v in self.kernel_launches_by_device.items()}


class GraphExecutable:
    """A plan callable captured as one CUDA graph for one padded bucket.

    Static device buffers hold the query batch (``static_input``), for an
    instrumented read the real batch size as an int32 scalar filled
    before each replay, and each ``bind`` operand (copied in before each
    replay; a new length is a new cache key).  A call replays the graph
    on the current stream and returns the graph's static outputs, which
    the next replay overwrites: the caller copies them out in stream
    order before it replays again.

    The graph records raw device pointers, so the executable keeps the
    callable (``fn``), and with it the plan and every tensor the graph
    reads (the generation's keys, model state, health edges), for as
    long as it lives: an in-flight slot that holds the executable keeps
    a swapped-out generation's memory from being handed out again before
    the replay has read it.
    """

    def __init__(self, fn: Callable, bucket: int, bind: Tuple,
                 instrumented: bool, device,
                 stats: Optional[GraphStats] = None):
        self.fn = fn
        self.bucket = int(bucket)
        self.instrumented = bool(instrumented)
        self.stats = stats
        #: the card the graph is captured on and replays on
        self.device = torch.device(device)
        self.static_input = torch.zeros(self.bucket, dtype=torch.int64,
                                        device=device)
        self.static_n = (torch.full((), self.bucket, dtype=torch.int32,
                                    device=device)
                         if self.instrumented else None)
        self.static_bind = tuple(b.clone() for b in bind)
        self._last_bind = tuple(bind)
        args = ((self.static_n,) if self.instrumented else ()) \
            + self.static_bind
        side = torch.cuda.Stream(device, priority=0)
        side.wait_stream(torch.cuda.current_stream(device))
        graph = torch.cuda.CUDAGraph()
        # capture_begin records on the current device: make it the card
        with _CAPTURE_LOCK, torch.cuda.device(self.device), \
                torch.cuda.stream(side):
            eager = fn(self.static_input, *args)
            before = kernel_launch_counts()
            # a garbage collection inside the capture could free a graph
            # or a CUDA buffer on this thread, which ends the capture
            gc_on = gc.isenabled()
            gc.disable()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn(self.static_input, *args)
            finally:
                graph.capture_end()
                if gc_on:
                    gc.enable()
            after = kernel_launch_counts()
            #: kernel launches recorded in the graph, by kernel name
            self.captured = {k: after[k] - before[k] for k in after}
            graph.replay()
            side.synchronize()
            _check_replay(eager, out)
        self.graph = graph
        self.out = out
        if stats is not None:
            stats.note(self, warm=True)

    def __call__(self, q, *rest):
        if q is not self.static_input:
            self.static_input.copy_(q, non_blocking=True)
        if self.instrumented:
            self.static_n.fill_(int(rest[0]))
            rest = rest[1:]
        for i, b in enumerate(rest):
            if b is not self._last_bind[i]:
                self.static_bind[i].copy_(b, non_blocking=True)
        self._last_bind = tuple(rest)
        with torch.cuda.device(self.device):
            self.graph.replay()
        if self.stats is not None:
            self.stats.note(self, warm=False)
        return self.out


def _check_replay(eager, replayed) -> None:
    """The validation replay must give the eager run's outputs bit for
    bit (same inputs): a capture that recorded anything else raises."""
    if isinstance(eager, tuple):
        for e, r in zip(eager, replayed):
            _check_replay(e, r)
        return
    if not torch.equal(eager, replayed):
        raise RuntimeError("CUDA graph replay differs from the eager run "
                           "it was captured from")


class ExecutableCache:
    """(context key, kind, aux, bucket, device) -> ready-to-run
    executable.

    A **miss** builds the executable (a captured CUDA graph for a plan's
    callable on a CUDA device, the callable itself otherwise); a **hit**
    runs a built one with only data operands changing.  Counters feed
    `ServiceMetrics`, so a steady-state miss is a test failure, not a
    latency mystery.  `invalidate(keep_version=...)` evicts every entry
    of older generations on hot swap; in-flight slots hold direct
    references to their executables, so eviction never races a running
    batch.
    """

    def __init__(self, metrics=None, recorder=None):
        self._mu = threading.Lock()
        self._exes: dict = {}
        self.hits = 0
        self.misses = 0
        self.warm_compiles = 0
        self.metrics = metrics
        #: optional `repro_torch.obs.trace.SpanRecorder`: every build is a
        #: "compile" span.
        self.recorder = recorder
        #: replay accounting of every graph this cache built
        self.graph_stats_sink = GraphStats()

    # -- stats -----------------------------------------------------------
    def counters(self) -> Tuple[int, int]:
        with self._mu:
            return self.hits, self.misses

    @property
    def hit_rate(self) -> float:
        with self._mu:
            n = self.hits + self.misses
            return self.hits / n if n else 0.0

    def __len__(self) -> int:
        with self._mu:
            return len(self._exes)

    def graph_stats(self) -> Dict[str, Any]:
        """Graphs built and replayed, and the kernel launches replayed,
        over the cache's life (`GraphStats`)."""
        return self.graph_stats_sink.snapshot()

    def graph_launches_by_device(self) -> Dict[str, Dict[str, int]]:
        """`graph_stats`'s kernel launches split by card."""
        return self.graph_stats_sink.by_device()

    # -- build/get -------------------------------------------------------
    def _build(self, fn, bucket: int, bind: Tuple, device,
               instrumented: bool = False):
        """Capture ``fn`` for the padded bucket when it is a plan's
        callable on a CUDA device; otherwise return it unchanged (the
        CPU, or an injected plain callable)."""
        if getattr(fn, "lookup_plan", None) is None \
                or device.type != "cuda":
            return fn
        return GraphExecutable(fn, bucket, bind, instrumented, device,
                               stats=self.graph_stats_sink)

    def get(self, ctx: AsyncContext, kind: str, aux: int, bucket: int,
            make_fn: Callable, device, warm: bool = False):
        """Return the executable for one cell on ``device`` (the card
        whose replica ``ctx`` reads), building it on a miss.

        ``make_fn`` produces the source callable (``gen.fn``, a merged fn,
        a scan); it only runs on a miss.  ``warm=True`` counts the build
        as a warm-up compile instead of a serving-path miss.
        """
        key = (ctx.key, kind, int(aux), int(bucket), device)
        with self._mu:
            exe = self._exes.get(key)
            hit = exe is not None
            # warm-up traffic never counts toward serving hit/miss
            if warm:
                self.warm_compiles += 0 if hit else 1
            elif hit:
                self.hits += 1
            else:
                self.misses += 1
        if exe is None:
            with maybe_span(self.recorder, "compile", cat="compile",
                            kind=kind, aux=int(aux), bucket=int(bucket),
                            version=ctx.key[0], warm=bool(warm)):
                exe = self._build(
                    make_fn(), bucket, ctx.bind, device,
                    instrumented=ctx.instrumented and kind == "read")
            with self._mu:
                self._exes[key] = exe
        if self.metrics is not None:
            self.metrics.note_cache(hit=hit, warm=warm)
        return exe

    def invalidate(self, keep_version=None) -> int:
        """Evict entries; with ``keep_version`` set (one version or an
        iterable of them), only entries whose context belongs to another
        generation go."""
        with self._mu:
            if keep_version is None:
                n = len(self._exes)
                self._exes.clear()
                return n
            keep = (set(keep_version)
                    if isinstance(keep_version, (set, frozenset, tuple,
                                                 list))
                    else {keep_version})
            stale = [k for k in self._exes if k[0][0] not in keep]
            for k in stale:
                del self._exes[k]
            return len(stale)

    def warmup(self, ctx: AsyncContext, buckets, device,
               scan_lengths=()) -> int:
        """Build read (and optionally scan) executables for ``buckets``
        on ``device`` and run one dummy batch through each: after this,
        the first real
        batch of a warmed bucket is a cache hit with no capture and no
        first-touch initialization.  A graph ran its dummy batch when it
        was built (a built graph may already be serving, so it is not
        replayed here); a plain callable runs one now.  Runs off the
        dispatch thread (service `start()`, or the post-publish warm
        thread)."""
        n = 0
        cells = [("read", 0, lambda: ctx.read_fn)]
        cells += [("scan", int(m), (lambda m=m: ctx.scan_fn(int(m))))
                  for m in scan_lengths]
        for bucket in buckets:
            for kind, aux, make_fn in cells:
                exe = self.get(ctx, kind, aux, int(bucket), make_fn,
                               device, warm=True)
                if not isinstance(exe, GraphExecutable):
                    args = ((int(bucket),)
                            if ctx.instrumented and kind == "read" else ())
                    dummy = encode_keys(
                        np.full(int(bucket), ctx.sample_key, np.uint64),
                        device)
                    with device_guard(device):
                        exe(dummy, *args, *ctx.bind)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                n += 1
        return n


class AsyncExecutor:
    """Slot-ring continuous batching over one service's dispatch path.

    Two daemon threads once `start()`ed:

      dispatch    waits on the micro-batcher, takes batches in admission
                  order, walks the service's work items (re-pinning per
                  run for the mutable service), resolves executables
                  through the cache, and LAUNCHES device work on the
                  executor's stream without waiting; host work (inserts)
                  is applied inline so a later read run observes it, then
                  rides the ring as an already-final slot to keep
                  completion in order.
      completion  pops slots in FIFO order, waits on each launch's own
                  event, slices per request, resolves futures, records
                  the decomposed latencies.

    Stopped, it degrades to an inline engine: `drain()` launches and
    completes everything on the caller's thread.
    """

    def __init__(self, service, slots: int = 4):
        if slots < 2:
            raise ValueError("async executor needs >= 2 slots "
                             "(double buffering)")
        self.svc = service
        self.slots = int(slots)
        #: card -> the stream every launch of this executor on that card
        #: goes on (a CPU device has none).  torch hands streams out
        #: round-robin from a pool per priority; the executor takes a
        #: high-priority one, so it is never the default-priority side
        #: stream a graph is being captured on
        self.streams = {d: torch.cuda.Stream(d, priority=-1)
                        for d in distinct(service.devices)
                        if d.type == "cuda"}
        #: the first card's stream (None: the CPU)
        self.stream = self.streams.get(service.devices[0])
        self._ring: "queue.Queue" = queue.Queue(maxsize=self.slots)
        # pinned host output sets (one dict of buffers each): a launch
        # takes one per lane it launches on (one for a broadcast batch,
        # one per touched shard for a routed one) and its slot gives them
        # back when it completes, so no set is reused before the batch
        # that wrote it was copied out.  deque pop/append are atomic: the
        # dispatch thread takes, the completion thread gives back.
        self._free_hosts: "collections.deque" = collections.deque()
        self._launch_mu = threading.Lock()   # serializes take+launch order
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._stop = threading.Event()
        self._dispatch_t: Optional[threading.Thread] = None
        self._complete_t: Optional[threading.Thread] = None

    @property
    def running(self) -> bool:
        return self._dispatch_t is not None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> threading.Thread:
        """Spawn the dispatch + completion pair; returns the dispatch
        thread (the service exposes it as its flusher `_thread`)."""
        if self._dispatch_t is not None:
            return self._dispatch_t
        self._stop.clear()
        self._complete_t = threading.Thread(
            target=self._completion_loop, name="lookup-completer",
            daemon=True)
        self._dispatch_t = threading.Thread(
            target=self._dispatch_loop, name="lookup-dispatcher",
            daemon=True)
        self._complete_t.start()
        self._dispatch_t.start()
        return self._dispatch_t

    def stop(self) -> None:
        """Join both threads, completing every admitted request: the
        dispatch loop force-drains admissions on its way out, the
        completion loop runs the ring dry before honoring the sentinel,
        and a final inline drain covers the join window."""
        if self._dispatch_t is None:
            return
        self._stop.set()
        self.svc.batcher.wake()
        self._dispatch_t.join()
        self._ring.put(_STOP)
        self._complete_t.join()
        self._dispatch_t = None
        self._complete_t = None
        self._stop.clear()
        self.drain()   # anything admitted during the join window

    # -- loops -----------------------------------------------------------
    def _dispatch_loop(self) -> None:
        svc = self.svc
        while not self._stop.is_set():
            if svc.batcher.wait_ready(timeout=5.0,
                                      until=self._stop.is_set):
                with self._launch_mu:
                    batch = svc.batcher.take(force=False)
                    if batch:
                        self._launch_batch(batch)
        # exit path: launch everything admitted before stop()
        self._drain_launches()

    def _completion_loop(self) -> None:
        while True:
            slot = self._ring.get()
            if slot is _STOP:
                return
            self._complete_slot(slot)

    # -- launching -------------------------------------------------------
    def _launch_batch(self, batch) -> None:
        """Walk the service's work items lazily and in order: an insert
        item is APPLIED when reached, so the next run's pinned context
        observes it, while device items launch without waiting."""
        for item in self.svc._async_work_items(batch):
            self._launch_item(item)

    def _launch_item(self, item: WorkItem) -> None:
        svc = self.svc
        group = item.group
        t_oldest = group[0].t_submit
        if item.kind == "insert":
            t0 = time.perf_counter()
            try:
                host = item.apply_fn(group)
            except BaseException as e:   # noqa: BLE001 — fail the run only
                self._put(_Slot(group=group, kind=item.kind, error=e,
                                t_submit_oldest=t_oldest, t_launch=t0,
                                is_insert=True))
                return
            self._put(_Slot(group=group, kind=item.kind, host=host,
                            m=sum(r.keys.size for r in group),
                            t_submit_oldest=t_oldest, t_launch=t0,
                            is_insert=True))
            return

        keys = (group[0].keys if len(group) == 1
                else np.concatenate([r.keys for r in group]))
        t0, c0 = time.perf_counter(), time.thread_time()
        ctx = item.ctx
        instr = False
        routed = isinstance(ctx, RoutedContext)
        version = -1
        hosts: List[Dict] = []

        def take_host() -> Dict:
            try:
                host = self._free_hosts.pop()
            except IndexError:
                host = {}
            hosts.append(host)
            return host

        try:
            if routed:
                routes = svc.dispatcher.routes_for(group, ctx.topology)
                out = svc.dispatcher.launch(
                    ctx, item.kind, item.aux, keys, routes=routes,
                    exec_cache=svc.exec_cache, take_host=take_host,
                    streams=self.streams)
                exe, padded = out.exes, out.padded
                version = ctx.key[0]
            elif not (isinstance(ctx, tuple) and ctx
                      and all(isinstance(c, AsyncContext) for c in ctx)):
                raise TypeError(
                    f"no dispatch path for a {type(ctx).__name__} context")
            else:
                disp = svc.dispatcher
                padded = disp.padded_size(keys.size)
                bucket = padded // disp.n_shards
                exe = tuple(
                    svc.exec_cache.get(
                        c, item.kind, item.aux, bucket,
                        ((lambda c=c: c.read_fn) if item.kind == "read"
                         else (lambda c=c: c.scan_fn(item.aux))), dev)
                    for c, dev in zip(ctx, disp.devices))
                instr = ctx[0].instrumented and item.kind == "read"
                out = disp.launch(exe, keys, [c.bind for c in ctx],
                                  [take_host() for _ in ctx],
                                  instrumented=instr, streams=self.streams)
                version = ctx[0].key[0]
        except BaseException as e:       # noqa: BLE001 — fail the group only
            self._put(_Slot(group=group, kind=item.kind, error=e,
                            ctx=ctx, hosts=hosts, t_submit_oldest=t_oldest,
                            t_launch=t0))
            return
        rec = svc.recorder
        if rec is not None:
            # one span per launched slot, carrying the (contiguous,
            # admission-ordered) rid range it holds, and the CPU time
            # the dispatch thread spent in it (the rest is waiting)
            rec.add("launch", t0, time.perf_counter(), cat="serve",
                    cpu_s=time.thread_time() - c0,
                    kind=item.kind, padded=int(padded),
                    n_keys=int(keys.size), n_requests=len(group),
                    rid_first=group[0].rid, rid_last=group[-1].rid)
        self._put(_Slot(group=group, kind=item.kind, out=out, exe=exe,
                        ctx=ctx, hosts=hosts, m=keys.size, padded=padded,
                        t_submit_oldest=t_oldest, t_launch=t0,
                        version=version, instrumented=instr,
                        routed=routed))

    def _put(self, slot: _Slot) -> None:
        with self._inflight_cv:
            self._inflight += 1
            depth = self._inflight
        if self.svc.metrics is not None:
            self.svc.metrics.note_slot_depth(depth)
        if self.running:
            self._ring.put(slot)   # blocks when the ring is full: bounded
            return
        # inline mode has no completion thread to make room: keep the
        # bounded-ring invariant by completing the oldest slot here
        while True:
            try:
                self._ring.put_nowait(slot)
                return
            except queue.Full:
                self._complete_slot(self._ring.get())

    # -- completion ------------------------------------------------------
    def _complete_slot(self, slot: _Slot) -> None:
        svc = self.svc
        try:
            if slot.error is not None:
                for r in slot.group:
                    r.future._set_exception(slot.error)
            elif slot.is_insert:
                svc._complete_insert_slot(slot)
            else:
                t_wait, c0 = time.perf_counter(), time.thread_time()
                try:
                    if slot.routed:
                        out, route_stats, _ = slot.out.finalize()
                    else:
                        out = svc.dispatcher.complete(slot.out)
                except BaseException as e:   # noqa: BLE001 — device failure
                    for r in slot.group:     # fails the slot, not the loop
                        r.future._set_exception(e)
                    return
                t_end, cpu_s = time.perf_counter(), time.thread_time() - c0
                if slot.routed:
                    # per-shard stats land in each SHARD generation's
                    # health record; route skew feeds the metrics
                    for ver, stats in route_stats:
                        svc._note_health(ver, stats, t_end)
                    svc.metrics.observe_route(slot.out.counts,
                                              slot.out.padded)
                elif slot.instrumented:
                    # route the device-reduced stats to the record of the
                    # generation the slot ran on
                    out, stats = out
                    svc._note_health(slot.version, stats, t_end)
                off = 0
                for r in slot.group:
                    end = off + r.keys.size
                    r.future._set_result(
                        tuple(o[off:end] for o in out)
                        if isinstance(out, tuple) else out[off:end])
                    off = end
                rec = svc.recorder
                if rec is not None:
                    rec.add("finalize", t_wait, t_end, cat="serve",
                            cpu_s=cpu_s, kind=slot.kind, n_keys=slot.m,
                            rid_first=slot.group[0].rid,
                            rid_last=slot.group[-1].rid)
                    for r in slot.group:
                        rec.request(r.rid, kind=r.kind,
                                    n_keys=r.keys.size,
                                    t_submit=r.t_submit,
                                    t_launch=slot.t_launch, t_end=t_end)
                svc.metrics.observe_batch(
                    n_keys=slot.m, padded=slot.padded,
                    n_requests=len(slot.group),
                    t_oldest_submit=slot.t_submit_oldest,
                    t_start=slot.t_launch, t_end=t_end,
                    per_request=[(r.t_submit, r.keys.size, r.priority)
                                 for r in slot.group])
        finally:
            # the device is done with the batch: its graph(s),
            # generation(s) and delta may go now, and its host sets serve
            # the next launches
            slot.out = slot.exe = slot.ctx = None
            self._free_hosts.extend(slot.hosts)
            slot.hosts = []
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    # -- synchronous faces ------------------------------------------------
    def _drain_launches(self) -> int:
        """Force-take and launch until the admission queue is empty."""
        n = 0
        with self._launch_mu:
            while True:
                batch = self.svc.batcher.take(force=True)
                if not batch:
                    return n
                self._launch_batch(batch)
                n += 1

    def _complete_ring_inline(self) -> None:
        """Run the completion side on the caller's thread (no-thread
        mode: synchronous tests, `lookup()` without `start()`)."""
        while True:
            try:
                slot = self._ring.get_nowait()
            except queue.Empty:
                return
            self._complete_slot(slot)

    def _wait_idle(self, timeout: Optional[float] = None) -> bool:
        with self._inflight_cv:
            return self._inflight_cv.wait_for(
                lambda: self._inflight == 0, timeout=timeout)

    def flush(self) -> bool:
        """Launch one due batch if any; wait until in-flight work is
        complete (same observable effect as the sync `flush`)."""
        launched = False
        with self._launch_mu:
            batch = self.svc.batcher.take(force=False)
            if batch:
                self._launch_batch(batch)
                launched = True
        self._settle()
        return launched

    def drain(self) -> int:
        """Force-dispatch until the queue is empty AND every launched
        slot has completed; returns the batch count.  Safe to call from
        any thread, with or without the loops running."""
        n = self._drain_launches()
        self._settle()
        return n

    def _settle(self) -> None:
        if self.running:
            self._wait_idle()
        else:
            self._complete_ring_inline()
