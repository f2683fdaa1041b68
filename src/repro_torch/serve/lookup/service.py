"""`LookupService`: admission -> micro-batch -> dispatch, over one card
or several.

Clients `submit()` small uint64 key arrays and get futures; a single
flusher (the background thread started by `start()`, or explicit
`flush()`/`drain()` calls) drains the micro-batcher in admission order
and runs one plan-compiled lookup per batch.  One flusher + in-order
draining gives FIFO completion per client for free.

Results are LB positions (``D[pos]`` is the smallest key >= query, the
paper's lower-bound semantics), bit-identical to a direct
`repro_torch.core` lookup on the same queries and to the reference's
sync `repro.serve.lookup.LookupService`.

Hot-swap: `swap_keys(new_keys)` rebuilds outside every lock and
publishes atomically; batches in flight complete against the generation
they were dispatched with: nothing drains, nothing blocks.

Executors: ``executor="sync"`` is the loop above (serial take -> launch
-> wait -> complete), the bit-exact reference every other path is held
against.  ``executor="async"`` swaps in the continuous-batching engine
(`serve.lookup.executor`): an executable cache of CUDA graphs keyed by
(generation, kind, batch bucket), a dispatch thread that launches on its
own stream without waiting, and a bounded ring of in-flight slots
completed in FIFO order.

Devices: ``device`` pins one; ``devices`` lists several (a device may
repeat); neither means every visible CUDA card (`dispatch.
data_axis_devices`), as the reference's service defaults to every local
device (its `data_axis_mesh`).  With no card and no explicit device the
service raises; it never carries on on the CPU unless asked.  Over
several devices a broadcast batch is split into one contiguous slice a
device, each answered against that device's replica of the generation
and joined back in admission order, bit for bit the one-device answers
(`dispatch.ShardedDispatcher`); the health record of the batch is the
one-device record.  The registry places every generation on every
device before it publishes it, and a queued batch on any card keeps the
replica it reads alive until its slot completes.

Range routing: ``shards > 1`` (or an explicit ``topology``) partitions
the key space into contiguous ranges, each with its own generation, and
dispatch scatters a batch over the shard lanes and gathers it back in
admission order (`dispatch.RoutedDispatcher`).  Lane (shard, replica)
runs on its own device (`shard_replica_groups` over the service's
devices), where the registry placed that shard's generation; on one card
every lane runs on it.  ``autotune`` attaches the shadow retuner
(`repro_torch.autotune`).

The reference's service, its data mesh a list of devices.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.core import spec as spec_mod
from repro_torch.obs.alerts import AlertEngine, AlertRule, default_rules
from repro_torch.obs.health import HealthMonitor
from repro_torch.obs.trace import SpanRecorder, maybe_span
from repro_torch.serve.common import MonotonicCounter
from repro_torch.serve.lookup.admission import LookupFuture, MicroBatcher
from repro_torch.serve.lookup.dispatch import (PAD_QUANTUM, RoutedContext,
                                               RoutedDispatcher,
                                               ShardedDispatcher, distinct,
                                               serving_devices)
from repro_torch.serve.lookup.executor import (AsyncContext, AsyncExecutor,
                                               ExecutableCache, WorkItem)
from repro_torch.serve.lookup.metrics import ServiceMetrics
from repro_torch.serve.lookup.registry import (DEFAULT_NAME, Generation,
                                               IndexRegistry,
                                               RoutedGeneration)
from repro_torch.serve.lookup.topology import ShardTopology


#: The serving-default hyperparameters (the reference's).
DEFAULT_HYPER = {
    "rmi": dict(branching=4096),
    "pgm": dict(eps=64),
    "radix_spline": dict(eps=32, radix_bits=16),
}


def default_spec(index: str, backend: str = "torch") -> spec_mod.IndexSpec:
    """The serving-default `IndexSpec` for one index family."""
    return spec_mod.IndexSpec(index, dict(DEFAULT_HYPER.get(index, {})),
                              backend=backend).validated()


@dataclasses.dataclass(frozen=True)
class LookupServiceConfig:
    """Every field and default of the reference's config, with the
    port's backends ("torch" | "cuda")."""

    index: str = "rmi"                 # repro_torch.core.base.REGISTRY name
    hyper: Dict[str, Any] = dataclasses.field(default_factory=dict)
    last_mile: Optional[str] = None    # None -> the build's own choice
    backend: str = "torch"             # LookupPlan backend ("torch" | "cuda")
    max_batch: int = 4096              # keys per dispatch (flush trigger)
    deadline_ms: float = 2.0           # oldest-request flush deadline
    #: Per-latency-class flush budgets in ms, e.g. ``{"interactive":
    #: 1.0, "batch": 20.0}``; unknown classes fall back to
    #: ``deadline_ms``.  None = one deadline for everything.
    class_deadline_ms: Optional[Dict[str, float]] = None
    pad_quantum: int = PAD_QUANTUM
    max_client_keys: Optional[int] = None   # per-client pending-key cap
    client_rate: Optional[tuple] = None     # per-client (rate keys/s, burst)
    max_scan_length: int = 4096             # per-request scan-window cap
    #: Declarative alternative to index/hyper/backend/last_mile: when
    #: set, the spec wins WHOLESALE.
    spec: Optional[spec_mod.IndexSpec] = None
    #: Dispatch engine: "sync" (serial take -> wait -> complete, the
    #: bit-exact reference) or "async" (continuous batching: executable
    #: cache of CUDA graphs + double buffering + slot ring).
    executor: str = "sync"
    slots: int = 4                          # async in-flight slot ring depth
    #: Batch buckets the async warm-up builds; () = every pow2 bucket
    #: from pad_quantum up to padded(max_batch).
    warm_buckets: Tuple[int, ...] = ()
    #: Scan lengths warmed alongside (each is a shape axis).
    warm_scan_lengths: Tuple[int, ...] = ()
    #: Span recorder (bounded ring of ``trace_capacity`` spans: per-
    #: request ids from admission through completion, plus hot-swap
    #: lifecycle spans), exported by ``service.recorder.to_chrome()``.
    trace: bool = False
    trace_capacity: int = 65536
    #: Rolling-window metrics resolution.
    window_slot_s: float = 0.5
    window_slots: int = 240
    #: Optional p99 SLO target: request latencies above it burn error
    #: budget, reported per window.
    slo_p99_ms: Optional[float] = None
    #: Index-health telemetry, on by default: reads dispatch the plan's
    #: instrumented lookup (bit-identical positions plus device-reduced
    #: stats a batch) and a `HealthMonitor` keeps per-generation records.
    health: bool = True
    #: Alert rules over `health_snapshot()` keys; None -> the shipped
    #: `default_rules()`, () -> no rules.
    alert_rules: Optional[Tuple[AlertRule, ...]] = None
    #: Range-routed serving topology.  ``shards > 1`` partitions the key
    #: space into that many equal-count ranges, each with its own
    #: (smaller) index generation, and replaces broadcast dispatch with
    #: scatter/gather routing.  ``topology`` pins an explicit
    #: `ShardTopology` instead (wins over ``shards``/``replicas``, and
    #: forces the routed path even with one shard).
    shards: int = 1
    replicas: int = 1                       # read fan-out per shard
    topology: Optional[ShardTopology] = None
    #: Per-shard spec search: each shard's `IndexSpec` tuned against
    #: ONLY its slice (per-shard byte budget = Tuner.max_bytes / shards).
    #: None -> every shard reuses the service's resolved spec.
    shard_tuner: Optional[spec_mod.Tuner] = None
    #: Query-buffer donation, read by the reference's async and routed
    #: paths only.  Torch has no buffer donation, so this field has no
    #: effect on any path of the port.
    donate_queries: Optional[bool] = None
    #: Self-driving tuning: a `repro_torch.autotune.AutotuneConfig`
    #: attaches a `ShadowRetuner` to this service (alert-triggered,
    #: workload-aware retunes, oracle-verified hot swaps,
    #: `/autotune.json`).  With ``autotune.daemon`` the retuner thread
    #: starts and stops with the service; otherwise drive it through
    #: ``service.autotune.poll_once()``.
    autotune: Optional[Any] = None

    def resolved_spec(self) -> spec_mod.IndexSpec:
        """The validated `IndexSpec` every build of this service uses."""
        if self.spec is not None:
            return self.spec.validated()
        return spec_mod.coerce(self.index, self.hyper,
                               backend=self.backend,
                               last_mile=self.last_mile)


def _validate(cfg: LookupServiceConfig) -> None:
    """Refuse an unknown executor, and shard or replica counts below one
    (with the messages `ShardTopology.from_keys` raises for them)."""
    if cfg.executor not in ("sync", "async"):
        raise ValueError(
            f"executor must be 'sync' or 'async', got {cfg.executor!r}")
    if cfg.shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {cfg.shards}")
    if cfg.replicas < 1:
        raise ValueError("every shard needs at least one replica")


class LookupService:
    def __init__(self, keys: np.ndarray,
                 config: Optional[LookupServiceConfig] = None,
                 device=None, counter: Optional[MonotonicCounter] = None,
                 prebuilt: Optional[Generation] = None, devices=None):
        """Serve lookups over ``keys`` on ``device``, or over the list
        ``devices`` (neither: every visible CUDA card).  ``prebuilt``, a
        `Generation` over ``keys`` made by `IndexRegistry.make_generation`
        or a `RoutedGeneration` (either one served by another service),
        is published as the first generation instead of building one,
        placed first on whichever of this service's devices it is not
        on."""
        self.cfg = config if config is not None else LookupServiceConfig()
        _validate(self.cfg)
        #: the data axis: every device this service serves from
        self.devices = serving_devices(device, devices)
        #: span recorder, or None when tracing is off: every
        #: instrumentation site on the serve path shares this one object
        self.recorder = (SpanRecorder(self.cfg.trace_capacity)
                         if self.cfg.trace else None)
        self.registry = IndexRegistry(devices=self.devices)
        self.registry.recorder = self.recorder
        #: per-generation health monitor, or None when disabled: attached
        #: BEFORE the first publish so the first generation has a record
        shards_hint = (self.cfg.topology.n_shards
                       if self.cfg.topology is not None
                       else self.cfg.shards)
        self.health = (HealthMonitor(slot_s=self.cfg.window_slot_s,
                                     n_slots=self.cfg.window_slots,
                                     keep=max(8, 2 * (shards_hint + 1)))
                       if self.cfg.health else None)
        self.registry.health = self.health
        #: alert engine: always present (rules may be empty); evaluates
        #: only when asked (`check_alerts`, the driver's doctor report)
        self.alerts = AlertEngine(
            rules=(default_rules() if self.cfg.alert_rules is None
                   else self.cfg.alert_rules))
        self.dispatcher = ShardedDispatcher(
            devices=self.devices, pad_quantum=self.cfg.pad_quantum,
            recorder=self.recorder)
        self.metrics = ServiceMetrics(
            slo_p99_ms=self.cfg.slo_p99_ms,
            window_slot_s=self.cfg.window_slot_s,
            window_slots=self.cfg.window_slots)
        self.batcher = MicroBatcher(
            self.cfg.max_batch, self.cfg.deadline_ms / 1e3,
            counter=counter if counter is not None else MonotonicCounter(),
            max_client_keys=self.cfg.max_client_keys,
            client_rate=self.cfg.client_rate,
            recorder=self.recorder,
            class_deadlines=(
                {k: v / 1e3
                 for k, v in self.cfg.class_deadline_ms.items()}
                if self.cfg.class_deadline_ms is not None else None))
        self._dispatch_lock = threading.Lock()   # one batch at a time
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._warm_thread: Optional[threading.Thread] = None
        self.exec_cache = ExecutableCache(metrics=self.metrics,
                                          recorder=self.recorder)
        self._async = (AsyncExecutor(self, slots=self.cfg.slots)
                       if self.cfg.executor == "async" else None)
        # routed contexts, keyed on (generation version, lane epoch,
        # instrumented)
        self._rctx_cache: Dict[Tuple, RoutedContext] = {}
        # every publish lands here: routed topology and router updates
        # for both executors, plus (async only) invalidation on swap, so
        # compaction rebuilds, which publish without swap_keys, evict
        # stale executables too
        self.registry.subscribe(self._on_publish)
        if prebuilt is None:
            self.swap_keys(keys)
        elif isinstance(prebuilt, RoutedGeneration):
            self.registry.publish_routed(
                prebuilt.shards, prebuilt.topology, spec=prebuilt.spec,
                backend=prebuilt.backend)
        else:
            self.registry.publish_prebuilt(prebuilt)
        #: shadow retuner, or None: made AFTER the first publish so its
        #: trigger polls always see a live generation
        if self.cfg.autotune is not None:
            from repro_torch.autotune import ShadowRetuner
            self.autotune = ShadowRetuner(self, self.cfg.autotune)
        else:
            self.autotune = None

    # -- index lifecycle -------------------------------------------------
    def _resolve_topology(self, keys) -> Optional[ShardTopology]:
        """The serving topology for one key set, or None for broadcast.
        An explicit ``cfg.topology`` always routes (even single-shard:
        that is the degeneration-parity path); ``shards > 1`` builds an
        equal-count partition fresh per key set."""
        if self.cfg.topology is not None:
            return self.cfg.topology
        if self.cfg.shards > 1:
            return ShardTopology.from_keys(keys, self.cfg.shards,
                                           self.cfg.replicas)
        return None

    def swap_keys(self, keys: np.ndarray) -> Generation:
        """Rebuild on a fresh key set and hot-swap it in (no draining).
        Builds go through the config's resolved `IndexSpec`, so the
        published generation is spec-addressable (`Generation.spec`).
        With a routed topology this publishes one generation per range
        plus the topology, as a single atomic `RoutedGeneration`."""
        keys = np.asarray(keys, dtype=np.uint64)
        topo = self._resolve_topology(keys)
        if topo is None:
            return self.registry.build_and_publish(
                self.cfg.resolved_spec(), keys)
        return self.registry.build_and_publish_routed(
            self.cfg.resolved_spec(), keys, topo,
            tuner=self.cfg.shard_tuner)

    @property
    def generation(self) -> Generation:
        return self.registry.current()

    # -- client surface --------------------------------------------------
    def submit(self, keys, client=None,
               priority: str = "interactive") -> LookupFuture:
        """Admit one request; never blocks.  Completion needs a flusher:
        the background thread (`start()`/`with svc:`) or explicit
        `flush()`/`drain()` calls.  ``client`` is an optional fairness id
        (`max_client_keys`, `client_rate`: an over-limit submit raises
        `ClientBacklogFull`); ``priority`` is the latency class."""
        _, fut = self.batcher.submit(keys, client=client,
                                     priority=priority)
        return fut

    def scan(self, keys, length: int, client=None) -> LookupFuture:
        """Admit one range-scan request: the future resolves to
        ``(positions, window)`` where ``window[i]`` holds the ``length``
        records from ``LB(keys[i])`` as uint64 (``UINT64_MAX`` past the
        end)."""
        # the window is a [B, length] gather, so the client-supplied
        # length is bounded; a routed topology tightens the bound to the
        # smallest shard (a shard's spill window only repairs up to
        # min_shard_len records)
        gen = self.generation
        max_len = self.cfg.max_scan_length
        routed = isinstance(gen, RoutedGeneration)
        if routed:
            max_len = min(max_len, gen.max_scan_len)
        if not 1 <= length <= max_len:
            raise ValueError(f"scan length must be in [1, {max_len}]")
        # reject point-only indexes at admission; the per-group guard in
        # _complete_run still covers a hot-swap to a point-only index
        if gen.point_only if routed else gen.plan.point_only:
            raise ValueError(
                f"index {gen.plan.name!r} is point-only: no scans")
        _, fut = self.batcher.submit(keys, kind="scan", aux=int(length),
                                     client=client)
        return fut

    def lookup(self, keys, timeout: Optional[float] = 30.0) -> np.ndarray:
        """Synchronous convenience: submit + ensure progress + wait."""
        fut = self.submit(keys)
        if self._thread is None:
            self.drain()
        return fut.result(timeout)

    # -- flushing --------------------------------------------------------
    def _dispatch_once(self, force: bool = False) -> bool:
        """Take + process one batch; returns whether one was taken.
        Serialized by `_dispatch_lock`: take order == dispatch order ==
        completion order, which is the FIFO guarantee."""
        with self._dispatch_lock:
            batch = self.batcher.take(force=force)
            if not batch:
                return False
            self._process_batch(batch)
            return True

    @staticmethod
    def _runs(batch, key):
        """Yield maximal consecutive runs of ``batch`` sharing
        ``key(req)``, in order."""
        i = 0
        while i < len(batch):
            j = i
            while j < len(batch) and key(batch[j]) == key(batch[i]):
                j += 1
            yield batch[i:j]
            i = j

    def _process_batch(self, batch) -> None:
        """Split the taken batch into consecutive same-kind runs and
        dispatch each; admission order holds within and across runs.
        The generation is pinned ONCE for the whole batch: a hot-swap
        lands between batches, never inside one."""
        ctx = self._pin_context()
        for run in self._runs(batch, key=lambda r: r.kind):
            self._dispatch_run(run[0].kind, run, ctx)

    def _dispatch_run(self, kind: str, run, ctx=None) -> None:
        """Route one same-kind run; subclasses add kinds (inserts)."""
        if ctx is None:
            ctx = self._pin_context()
        if isinstance(ctx, RoutedContext):
            if kind == "scan":
                for group in self._runs(run, key=lambda r: r.aux):
                    self._complete_routed("scan", list(group),
                                          int(group[0].aux), ctx)
            else:
                self._complete_routed("read", list(run), 0, ctx)
            return
        lookup_fns, scan_for, version = ctx
        if kind == "scan":
            self._dispatch_scans(run, scan_for)
        else:
            self._dispatch_reads(run, lookup_fns, version)

    def _slice_gens(self, gen: Generation):
        """The copy of ``gen`` each dispatcher slice reads, in slice
        order."""
        return [gen.on(d) for d in self.devices]

    def _pin_context(self):
        """``(lookup callables, m -> scan callables, version)`` bound to
        ONE immutable generation, one callable a slice of the data axis
        (each over its device's replica).  With health on, the lookups
        are the plan's INSTRUMENTED lookup; ``version`` routes their
        stats to the right record.  Routed generations pin a
        `RoutedContext` instead (the topology and every lane's
        callables)."""
        gen = self.registry.current()
        if isinstance(gen, RoutedGeneration):
            return self._routed_context(gen)
        gens = self._slice_gens(gen)
        fns = tuple(g.instrumented_fn() if self.health is not None
                    else g.fn for g in gens)
        return (fns, lambda m: tuple(g.scan_fn(m) for g in gens),
                gen.version)

    def _routed_context(self, gen: RoutedGeneration) -> RoutedContext:
        """One executable-cache-addressable context per (generation,
        lane layout): every (shard, replica) lane gets its own
        `AsyncContext` keyed ``(shard version, replica)``, so each lane
        has its own graphs."""
        instrumented = self.health is not None
        key = (gen.version, self.dispatcher.lanes_epoch, instrumented)
        rctx = self._rctx_cache.get(key)
        if rctx is not None:
            return rctx
        lane_ctxs = []
        for s, sgen in enumerate(gen.shards):
            ctxs = []
            for r, lane in enumerate(self.dispatcher.lanes[s]):
                lgen = sgen.on(lane.device)     # the lane's card's copy
                ctxs.append(AsyncContext(
                    key=(sgen.version, r),
                    read_fn=(lgen.instrumented_fn() if instrumented
                             else lgen.fn),
                    scan_fn=(lambda m, s=s, g=gen, d=lane.device:
                             g.shard_scan_fn(s, int(m), d)),
                    bind=(), sample_key=sgen.sample_key,
                    instrumented=instrumented))
            lane_ctxs.append(tuple(ctxs))
        rctx = RoutedContext(
            topology=gen.topology,
            lane_ctxs=tuple(lane_ctxs),
            offsets=tuple(gen.topology.offsets),
            versions=gen.shard_versions,
            version=gen.version,
            instrumented=instrumented)
        self._rctx_cache[key] = rctx
        return rctx

    def _complete_routed(self, kind: str, group, aux: int,
                         rctx: RoutedContext) -> None:
        """Synchronous routed dispatch of one same-(kind, aux) group:
        scatter over shard lanes, finalize (gather in admission order),
        complete futures: the routed twin of `_complete_run`."""
        keys = (group[0].keys if len(group) == 1
                else np.concatenate([r.keys for r in group]))
        t0 = time.perf_counter()
        try:
            routes = self.dispatcher.routes_for(group, rctx.topology)
            handle = self.dispatcher.launch(rctx, kind, aux, keys,
                                            routes=routes)
            out, stats, padded = handle.finalize()
        except BaseException as e:  # noqa: BLE001 — fail the group only
            for r in group:
                r.future._set_exception(e)
            return
        t1 = time.perf_counter()
        if self.recorder is not None:
            # the broadcast path's "device" span: launch to answers
            self.recorder.add("device", t0, t1, cat="serve",
                              padded=int(padded),
                              n_shards=self.dispatcher.n_shards)
        for ver, st in stats:
            self._note_health(ver, st, t1)
        self.metrics.observe_route(handle.counts, padded)
        self._finish_group(group, out, t0, t1, keys.size, padded)

    def _complete_run(self, group, make_fn, version: int = -1,
                      instrumented: bool = False) -> None:
        """Dispatch one request group through ``make_fn()`` and complete
        its futures in order.  Failures fail the group's futures, never
        the flusher, including failures to make the callable (a scan of
        a point-only plan).  Instrumented reads fold the stats into the
        health record of ``version``; futures never see them."""
        keys = (group[0].keys if len(group) == 1
                else np.concatenate([r.keys for r in group]))
        t0 = time.perf_counter()
        try:
            out = self.dispatcher(make_fn(), keys,
                                  n_valid_arg=instrumented)
        except BaseException as e:  # noqa: BLE001 — fail the group, not the flusher
            for r in group:
                r.future._set_exception(e)
            return
        t1 = time.perf_counter()
        if instrumented:
            out, stats = out
            self._note_health(version, stats, t1)
        self._finish_group(group, out, t0, t1, keys.size,
                           self.dispatcher.padded_size(keys.size))

    def _finish_group(self, group, out, t0: float, t1: float,
                      n_keys: int, padded: int) -> None:
        """Slice the batch result per request in admission order, resolve
        futures, record request spans, and fold the batch into the
        metrics."""
        off = 0
        for r in group:
            end = off + r.keys.size
            r.future._set_result(tuple(o[off:end] for o in out)
                                 if isinstance(out, tuple) else out[off:end])
            off = end
        if self.recorder is not None:
            for r in group:
                self.recorder.request(r.rid, kind=r.kind,
                                      n_keys=r.keys.size,
                                      t_submit=r.t_submit,
                                      t_launch=t0, t_end=t1)
        self.metrics.observe_batch(
            n_keys=n_keys,
            padded=padded,
            n_requests=len(group),
            t_oldest_submit=group[0].t_submit,
            t_start=t0, t_end=t1,
            per_request=[(r.t_submit, r.keys.size, r.priority)
                         for r in group])

    def _dispatch_reads(self, batch, lookup_fns,
                        version: int = -1) -> None:
        self._complete_run(batch, lambda: lookup_fns, version=version,
                           instrumented=self.health is not None)

    def _dispatch_scans(self, batch, scan_for) -> None:
        """Dispatch a run of scan requests, grouped by scan length (the
        window width is a shape axis).  Futures resolve to ``(positions,
        window)`` per request."""
        for group in self._runs(batch, key=lambda r: r.aux):
            m = int(group[0].aux)
            self._complete_run(group, lambda m=m: scan_for(m))

    # -- async executor plumbing ------------------------------------------
    def _async_context(self):
        """Pin one generation as executable-cache-addressable contexts,
        one `AsyncContext` a slice of the data axis (a tuple, each over
        its device's replica): the async analogue of `_pin_context` (a
        hot swap lands between batches, never inside one).  Routed
        generations return the (cached) `RoutedContext`; the executor
        branches on the type."""
        gen = self.registry.current()
        if isinstance(gen, RoutedGeneration):
            return self._routed_context(gen)
        instrumented = self.health is not None
        return tuple(AsyncContext(
            key=(gen.version,),
            read_fn=g.instrumented_fn() if instrumented else g.fn,
            scan_fn=g.scan_fn,
            bind=(),
            sample_key=gen.sample_key,
            instrumented=instrumented) for g in self._slice_gens(gen))

    def _async_work_items(self, batch):
        """Lazily yield `WorkItem`s for one taken batch, in admission
        order, with the context pinned ONCE for the whole batch (the
        mutable subclass re-pins per run and interleaves inserts)."""
        ctx = self._async_context()
        for run in self._runs(batch, key=lambda r: r.kind):
            yield from self._async_items_for_run(run[0].kind, run, ctx)

    def _async_items_for_run(self, kind, run, ctx):
        if kind == "scan":
            # scan length is a shape axis: split like the sync path
            for group in self._runs(run, key=lambda r: r.aux):
                yield WorkItem(kind="scan", group=list(group), ctx=ctx,
                               aux=int(group[0].aux))
        else:
            yield WorkItem(kind="read", group=list(run), ctx=ctx)

    def _complete_insert_slot(self, slot) -> None:
        """Resolve a host-ready insert slot (mutable service only)."""
        raise NotImplementedError(
            "insert completion on a read-only service")

    def _resolved_warm_buckets(self, dispatcher=None):
        d = self.dispatcher if dispatcher is None else dispatcher
        if self.cfg.warm_buckets:
            return tuple(sorted({d.padded_size(int(b))
                                 for b in self.cfg.warm_buckets}))
        # every pow2 bucket steady traffic can dispatch at: quantum ..
        # padded(max_batch), log2-many executables, built once
        buckets, b = [], d.padded_size(1)
        top = d.padded_size(self.cfg.max_batch)
        while b < top:
            buckets.append(b)
            b = d.padded_size(b + 1)
        buckets.append(top)
        return tuple(buckets)

    def warm_now(self) -> int:
        """Synchronously build the executables of the CURRENT generation
        over the configured warm buckets; returns the number of warmed
        cells.  `start()` runs this before serving; hot swaps re-run it
        off-thread (`_on_publish`)."""
        if self._async is None:
            return 0
        ctxs = self._async_context()
        if isinstance(ctxs, RoutedContext):
            return self._warm_routed(ctxs)
        disp = self.dispatcher
        # the executables run on one slice of each padded bucket
        buckets = tuple(b // disp.n_shards
                        for b in self._resolved_warm_buckets())
        n = 0
        with maybe_span(self.recorder, "warmup", cat="lifecycle",
                        version=ctxs[0].key[0], n_buckets=len(buckets)):
            # slices on one device share its replica, so its executables
            for dev in distinct(disp.devices):
                n += self.exec_cache.warmup(
                    ctxs[disp.devices.index(dev)], buckets, dev,
                    scan_lengths=self.cfg.warm_scan_lengths)
        return n

    def warm_wait(self, timeout: Optional[float] = None) -> None:
        """Block until the background re-warm started by the last hot-swap
        publish finishes (no-op when none is in flight)."""
        w = self._warm_thread
        if w is not None and w.is_alive():
            w.join(timeout)

    def _warm_routed(self, rctx: RoutedContext) -> int:
        """Build every (shard, replica) lane's executables on that lane's
        own dispatcher: each lane has its own graphs."""
        n = 0
        with maybe_span(self.recorder, "warmup", cat="lifecycle",
                        version=rctx.version,
                        n_shards=self.dispatcher.n_shards):
            for s, grp in enumerate(self.dispatcher.lanes):
                for r, lane in enumerate(grp):
                    n += self.exec_cache.warmup(
                        rctx.lane_ctxs[s][r],
                        self._resolved_warm_buckets(lane), lane.device,
                        scan_lengths=self.cfg.warm_scan_lengths)
        return n

    def _on_publish(self, name: str, gen) -> None:
        """Registry publish hook: track the routed topology (both
        executors route at admission through it), then (async only)
        evict stale generations' executables and re-warm the new one
        WITHOUT blocking the publisher (a compaction thread may be
        mid-swap holding its own locks)."""
        if name != DEFAULT_NAME:
            return
        if isinstance(gen, RoutedGeneration):
            if not isinstance(self.dispatcher, RoutedDispatcher):
                self.dispatcher = RoutedDispatcher(
                    gen.topology, devices=self.devices,
                    pad_quantum=self.cfg.pad_quantum,
                    recorder=self.recorder)
            else:
                self.dispatcher.set_replicas(gen.topology)
            self._rctx_cache.clear()
            # admission-time routing: each submit tags its request with
            # (topology, shard ids); a later hot swap invalidates the tag
            # by object identity and dispatch re-routes
            self.batcher.router = (
                lambda keys, t=gen.topology: (t, t.route(keys)))
            keep = (gen.version,) + gen.shard_versions
        else:
            self.batcher.router = None
            keep = gen.version
        if self._async is None:
            return
        self.exec_cache.invalidate(keep_version=keep)
        if self._thread is None:
            # not serving: start() warms synchronously before the first
            # dispatch
            return
        t = threading.Thread(target=self._warm_retry,
                             name="lookup-warmer", daemon=True)
        self._warm_thread = t
        t.start()

    def rebalance_replicas(self, total_replicas: Optional[int] = None,
                           window_s: float = 10.0) -> Tuple[int, ...]:
        """Re-apportion replica seats to the shards that actually take
        the traffic (each shard's health-record traffic window): the
        hottest range gets the replicas.  Only the read fan-out changes;
        split points and offsets stay, so admission-time routes remain
        valid.  Returns the new per-shard replica counts."""
        gen = self.registry.current()
        if not isinstance(gen, RoutedGeneration):
            raise ValueError("rebalance_replicas needs a routed topology")
        masses = []
        for sgen in gen.shards:
            mass = 0.0
            if self.health is not None:
                rec = self.health.get(sgen.version)
                if rec is not None:
                    mass = float(np.sum(rec.traffic_window(window_s)))
            masses.append(mass)
        topo = gen.topology.rebalanced_from_masses(
            masses, total_replicas=total_replicas)
        # each shard's copies on its new lanes' devices, before any lane
        # reads them
        for sgen, grp in zip(gen.shards, self.registry.shard_devices(topo)):
            sgen.place(grp)
        if self.dispatcher.set_replicas(topo):
            self._rctx_cache.clear()
        return topo.replicas

    def _warm_retry(self) -> None:
        """Warm the current context, tolerating construction windows (the
        mutable service publishes its first generation before its view
        pointer exists): retry briefly, then give up; a missed warm costs
        one build on the dispatch thread per bucket."""
        deadline = time.perf_counter() + 5.0
        while True:
            try:
                self.warm_now()
                return
            except Exception:   # noqa: BLE001 — warm-up is best-effort
                if time.perf_counter() >= deadline:
                    return
                time.sleep(0.005)

    # -- index-health telemetry --------------------------------------------
    def _note_health(self, version: int, stats, t_end: float) -> None:
        """Fold one completed batch's device-reduced stats into the
        health record of the generation it ran against."""
        if self.health is not None:
            self.health.accumulate(version, stats, t=t_end)

    def health_snapshot(self, window_s: float = 10.0) -> Dict[str, float]:
        """ONE flat key namespace over service + window + model health,
        what alert rules evaluate: the lifetime `ServiceMetrics`
        snapshot, the trailing-window metrics under a ``window_`` prefix
        (``window_covered_s`` reports actual coverage), and the current
        generation's health keys."""
        snap = self.metrics.snapshot()
        win = self.metrics.windowed(window_s)
        snap["window_covered_s"] = win.pop("window_s")
        snap.update({f"window_{k}": v for k, v in win.items()})
        if self.health is not None:
            snap.update(self.health.snapshot(window_s))
        snap["trace_dropped"] = float(self.recorder.n_dropped
                                      if self.recorder is not None else 0)
        snap["inflight_saturation"] = (
            snap.get("mean_inflight_slots", 0.0) / self.cfg.slots
            if self._async is not None and self.cfg.slots else 0.0)
        snap["serving"] = 1.0 if self._thread is not None else 0.0
        if self.autotune is not None:
            st = self.autotune.status()
            snap["autotune_alive"] = 1.0 if st.get("alive") else 0.0
            snap["autotune_triggered"] = float(st.get("n_triggered", 0))
            snap["autotune_swapped"] = float(st.get("n_swapped", 0))
            snap["autotune_rejected"] = float(st.get("n_rejected", 0))
        return snap

    def check_alerts(self, window_s: float = 10.0) -> list:
        """Evaluate every alert rule against a fresh `health_snapshot`;
        returns the events emitted by THIS evaluation (state transitions
        only)."""
        return self.alerts.evaluate(self.health_snapshot(window_s))

    def health_status(self, window_s: float = 10.0):
        """``(http_status, doc)`` for liveness surfaces: 503 when the
        background flusher is not running or a critical alert is firing,
        200 otherwise.  Evaluates the rules first."""
        self.check_alerts(window_s)
        firing = self.alerts.firing()
        critical = self.alerts.firing(severity="critical")
        serving = self._thread is not None
        ok = serving and not critical
        doc = {"status": "ok" if ok else "unhealthy",
               "serving": serving,
               "firing": firing, "critical": critical}
        return (200 if ok else 503), doc

    def flush(self) -> bool:
        """Dispatch one due batch if any (size or deadline trigger)."""
        if self._async is not None:
            return self._async.flush()
        return self._dispatch_once(force=False)

    def drain(self) -> int:
        """Force-dispatch until the queue is empty; returns batch count.
        In async mode this also waits for every in-flight slot, so no
        future is left unresolved when it returns."""
        if self._async is not None:
            return self._async.drain()
        n = 0
        while self._dispatch_once(force=True):
            n += 1
        return n

    # -- background flusher ----------------------------------------------
    def start(self) -> "LookupService":
        if self._thread is not None:
            return self
        if self._async is not None:
            # build the common buckets BEFORE serving: steady-state
            # dispatch then never captures a graph
            self.warm_now()
            self._thread = self._async.start()
            self._start_autotune()
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.is_set():
                if self.batcher.wait_ready(timeout=5.0,
                                           until=self._stop.is_set):
                    self._dispatch_once(force=False)
            self.drain()   # complete everything admitted before stop()

        self._thread = threading.Thread(
            target=_loop, name="lookup-flusher", daemon=True)
        self._thread.start()
        self._start_autotune()
        return self

    def _start_autotune(self) -> None:
        """Start the shadow-retuner daemon alongside the flusher (only
        when the config asked for one; `poll_once` stays available for
        explicit retunes either way)."""
        at = self.autotune
        if at is not None and at.cfg.daemon:
            at.start()

    def stop(self) -> None:
        """Stop the background flusher, completing everything admitted so
        far.  The service stays usable afterwards (submit + flush/drain,
        or a later start())."""
        if self._thread is None:
            return
        if self.autotune is not None:
            self.autotune.stop()   # no retunes against a draining service
        if self._async is not None:
            self._async.stop()
            self._thread = None
            w = self._warm_thread
            if w is not None and w.is_alive():
                w.join()   # never strand a capture thread past stop()
            return
        self._stop.set()
        self.batcher.wake()
        self._thread.join()
        self._thread = None
        self.drain()       # anything admitted during the join window
        self._stop.clear()

    def __enter__(self) -> "LookupService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
