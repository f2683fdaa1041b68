"""Per-batch serving metrics.

Everything the throughput benchmark and the ops story need: log-spaced
latency histograms (`repro_torch.obs.windows.LatencyHistogram` — O(log n)
bisect record, since this runs under the metrics lock on every batch
completion), batch occupancy (real keys / padded dispatch width — the
price of the deadline trigger), and aggregate lookups/sec over the
serving window.  The mutable service adds write-side observations:
insert batches/admissions, the current delta occupancy gauge (delta
keys / compaction threshold), and compaction count + latency.

Beyond the lifetime aggregates, every request latency also lands in a
`repro_torch.obs.windows.WindowedMetrics` ring, so `windowed(window_s=...)`
answers "what is the p99 *now*" — the rolling-window surface (with
optional SLO target + error-budget burn) that a mid-run regression
cannot hide from and that a p99-aware Tuner objective consumes.

A copy of the reference's `repro.serve.lookup.metrics`: `snapshot()`
has the reference's keys, held equal by `tests/test_torch_obs.py`.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.obs.windows import LatencyHistogram, WindowedMetrics

__all__ = ["LatencyHistogram", "ServiceMetrics", "WindowedMetrics"]


class ServiceMetrics:
    """Aggregated per-batch observations; `snapshot()` is the read API."""

    def __init__(self, slo_p99_ms: Optional[float] = None,
                 window_slot_s: float = 0.5, window_slots: int = 240):
        self._lock = threading.Lock()
        self.batch_latency = LatencyHistogram()
        self.queue_latency = LatencyHistogram()
        #: end-to-end: submit -> future resolved.  With the async
        #: executor, p99 decomposes as queue (admission->dispatch) +
        #: batch (dispatch->complete) ~= request — the observability
        #: contract that makes a p99 regression attributable.  Recorded
        #: PER REQUEST when the dispatch path passes `per_request`
        #: observations (both executors do), per batch otherwise.
        self.request_latency = LatencyHistogram()
        #: rolling-window request latencies: same observations
        #: as `request_latency`, sliced by completion time.
        self.windows = WindowedMetrics(slot_s=window_slot_s,
                                       n_slots=window_slots,
                                       slo_p99_ms=slo_p99_ms)
        self.n_batches = 0
        self.n_keys = 0
        self.n_requests = 0
        self.sum_occupancy = 0.0
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        # -- executor observability (async executor; zero otherwise) -----
        self.cache_hits = 0
        self.cache_misses = 0
        self.warm_compiles = 0
        self.sum_inflight = 0
        self.n_inflight_obs = 0
        self.max_inflight = 0
        # -- write side (mutable service; zero for read-only services) --
        self.insert_latency = LatencyHistogram()
        self.compaction_latency = LatencyHistogram()
        self.n_insert_batches = 0
        self.n_insert_keys = 0
        self.n_admitted = 0
        self.n_compactions = 0
        self.n_compaction_failures = 0
        self.delta_keys = 0
        self.delta_threshold = 0
        # -- latency classes ----------------------------------------------
        #: per-priority-class request counts/keys + latency histogram,
        #: populated when per_request observations carry a class tag
        self._class_stats: Dict[str, Dict] = {}
        # -- routed topology (zero for broadcast) -------------------------
        self.n_routed_batches = 0
        self.sum_route_skew = 0.0      # per-batch max/mean shard load
        self.max_route_skew = 0.0
        self._shard_stats: Dict[int, Dict[str, float]] = {}

    def observe_route(self, counts, padded: int) -> None:
        """One completed routed batch: per-shard key counts (including
        zeros for untouched shards) and the summed padded width.  Skew
        is max/mean over ALL shards — 1.0 is a perfectly balanced batch,
        n_shards is everything-in-one-shard."""
        counts = [int(c) for c in counts]
        total = sum(counts)
        n_shards = len(counts)
        mean = total / n_shards if n_shards else 0.0
        skew = (max(counts) / mean) if mean > 0 else 0.0
        with self._lock:
            self.n_routed_batches += 1
            self.sum_route_skew += skew
            if skew > self.max_route_skew:
                self.max_route_skew = skew
            for s, c in enumerate(counts):
                st = self._shard_stats.setdefault(
                    s, {"keys": 0, "batches": 0, "sum_occupancy": 0.0})
                if c:
                    st["keys"] += c
                    st["batches"] += 1
                    # per-shard occupancy vs an even split of the padded
                    # width: how full this shard's sub-batch ran
                    st["sum_occupancy"] += c / max(padded / n_shards, 1)

    def per_shard(self) -> list:
        """Per-shard load rows for the exporters (`/metrics.json` and
        the ``shard``-labelled Prometheus families)."""
        with self._lock:
            rows = []
            for s in sorted(self._shard_stats):
                st = self._shard_stats[s]
                rows.append({
                    "shard": s,
                    "keys": st["keys"],
                    "batches": st["batches"],
                    "mean_occupancy": (st["sum_occupancy"] / st["batches"]
                                       if st["batches"] else 0.0),
                })
            return rows

    def per_class(self) -> list:
        """Per-latency-class rows (requests, keys, p50/p99) — empty
        until a dispatch path reports 3-tuple per_request observations."""
        with self._lock:
            rows = []
            for name in sorted(self._class_stats):
                st = self._class_stats[name]
                rows.append({
                    "priority": name,
                    "requests": st["requests"],
                    "keys": st["keys"],
                    "mean_request_ms": st["latency"].mean * 1e3,
                    "p50_request_ms": st["latency"].quantile(0.50) * 1e3,
                    "p99_request_ms": st["latency"].quantile(0.99) * 1e3,
                })
            return rows

    def observe_batch(self, *, n_keys: int, padded: int, n_requests: int,
                      t_oldest_submit: float, t_start: float,
                      t_end: float,
                      per_request: Optional[Sequence[Tuple]] = None
                      ) -> None:
        """One completed dispatch.  ``per_request`` carries the batch's
        ``(t_submit, n_keys)`` — or ``(t_submit, n_keys, priority)`` —
        per request: request latency is then recorded per request
        (exactly what the trace's request spans hold, so trace-derived
        and histogram p99 reconcile) instead of once per batch at the
        oldest submit.  A 3-tuple's latency class additionally lands in
        the per-class counters/histograms (`snapshot()`'s ``class_*``
        keys)."""
        with self._lock:
            self.n_batches += 1
            self.n_keys += n_keys
            self.n_requests += n_requests
            self.sum_occupancy += n_keys / max(padded, 1)
            self.batch_latency.record(t_end - t_start)
            self.queue_latency.record(t_start - t_oldest_submit)
            if per_request:
                for t_submit, nk, *rest in per_request:
                    self.request_latency.record(t_end - t_submit)
                    self.windows.record(t_end - t_submit, units=nk, t=t_end)
                    if rest:
                        st = self._class_stats.setdefault(
                            str(rest[0]),
                            {"requests": 0, "keys": 0,
                             "latency": LatencyHistogram()})
                        st["requests"] += 1
                        st["keys"] += nk
                        st["latency"].record(t_end - t_submit)
            else:
                self.request_latency.record(t_end - t_oldest_submit)
                self.windows.record(t_end - t_oldest_submit, units=n_keys,
                                    t=t_end)
            if self.t_first is None:
                self.t_first = t_start
            self.t_last = t_end

    def note_cache(self, *, hit: bool, warm: bool = False) -> None:
        """One executable-cache access (from `ExecutableCache.get`).
        Warm-up accesses only count their compiles — hit-rate reflects
        serving traffic alone."""
        with self._lock:
            if warm:
                if not hit:
                    self.warm_compiles += 1
            elif hit:
                self.cache_hits += 1
            else:
                self.cache_misses += 1

    def note_slot_depth(self, depth: int) -> None:
        """In-flight slot count observed at one launch."""
        with self._lock:
            self.sum_inflight += depth
            self.n_inflight_obs += 1
            if depth > self.max_inflight:
                self.max_inflight = depth

    def observe_insert_batch(self, *, n_keys: int, admitted: int,
                             t_start: float, t_end: float) -> None:
        with self._lock:
            self.n_insert_batches += 1
            self.n_insert_keys += n_keys
            self.n_admitted += admitted
            self.insert_latency.record(t_end - t_start)
            if self.t_first is None:
                self.t_first = t_start
            self.t_last = t_end

    def observe_compaction(self, *, duration_s: float) -> None:
        # counts + latency only: the delta gauge has a single writer
        # (`set_delta_gauge`, fed the real post-compaction count)
        with self._lock:
            self.n_compactions += 1
            self.compaction_latency.record(duration_s)

    def observe_compaction_failure(self) -> None:
        with self._lock:
            self.n_compaction_failures += 1

    def set_delta_gauge(self, *, delta_keys: int, threshold: int) -> None:
        with self._lock:
            self.delta_keys = int(delta_keys)
            self.delta_threshold = int(threshold)

    def windowed(self, window_s: float = 10.0) -> Dict[str, float]:
        """Rolling-window request-latency snapshot: quantiles,
        key rate, and SLO budget burn over the trailing ``window_s`` —
        the read surface a live p99 regression cannot hide from."""
        snap = self.windows.snapshot(window_s)
        snap["lookups_per_s"] = snap.pop("units_per_s")
        snap["lookups"] = snap.pop("units")
        return snap

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            # the serving window spans ANY observation — insert-only
            # traffic sets t_first/t_last through observe_insert_batch
            # and must not read as a zero-length window
            window = ((self.t_last - self.t_first)
                      if self.t_first is not None
                      and self.t_last is not None
                      and self.t_last > self.t_first else 0.0)
            out = {
                "batches": self.n_batches,
                "requests": self.n_requests,
                "lookups": self.n_keys,
                "lookups_per_s": (self.n_keys / window) if window else 0.0,
                "mean_occupancy": (self.sum_occupancy / self.n_batches
                                   if self.n_batches else 0.0),
                "mean_batch_ms": self.batch_latency.mean * 1e3,
                "p50_batch_ms": self.batch_latency.quantile(0.50) * 1e3,
                "p99_batch_ms": self.batch_latency.quantile(0.99) * 1e3,
                "mean_queue_ms": self.queue_latency.mean * 1e3,
                "p99_queue_ms": self.queue_latency.quantile(0.99) * 1e3,
                "mean_request_ms": self.request_latency.mean * 1e3,
                "p50_request_ms": self.request_latency.quantile(0.50) * 1e3,
                "p99_request_ms": self.request_latency.quantile(0.99) * 1e3,
                "slo_p99_target_ms": (self.windows.slo_p99_ms
                                      if self.windows.slo_p99_ms is not None
                                      else 0.0),
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "cache_accesses": self.cache_hits + self.cache_misses,
                "cache_hit_rate": (
                    self.cache_hits / (self.cache_hits + self.cache_misses)
                    if self.cache_hits + self.cache_misses else 0.0),
                "warm_compiles": self.warm_compiles,
                "mean_inflight_slots": (self.sum_inflight
                                        / self.n_inflight_obs
                                        if self.n_inflight_obs else 0.0),
                "max_inflight_slots": self.max_inflight,
                "insert_batches": self.n_insert_batches,
                "insert_keys": self.n_insert_keys,
                "inserts_per_s": (self.n_insert_keys / window
                                  if window else 0.0),
                "admitted": self.n_admitted,
                "mean_insert_ms": self.insert_latency.mean * 1e3,
                "compactions": self.n_compactions,
                "compaction_failures": self.n_compaction_failures,
                "mean_compaction_ms": self.compaction_latency.mean * 1e3,
                "p99_compaction_ms": self.compaction_latency.quantile(0.99) * 1e3,
                "delta_keys": self.delta_keys,
                "delta_occupancy": (self.delta_keys / self.delta_threshold
                                    if self.delta_threshold else 0.0),
                "routed_batches": self.n_routed_batches,
                "route_skew": (self.sum_route_skew / self.n_routed_batches
                               if self.n_routed_batches else 0.0),
                "route_max_skew": self.max_route_skew,
                "route_shards": len(self._shard_stats),
            }
            # flat per-class keys ride the same namespace the alert
            # rules and exporters already consume
            for name, st in self._class_stats.items():
                out[f"class_{name}_requests"] = st["requests"]
                out[f"class_{name}_keys"] = st["keys"]
                out[f"class_{name}_p99_request_ms"] = (
                    st["latency"].quantile(0.99) * 1e3)
            return out
