"""Index-health records: prediction error + workload drift.

Model observability for the serve path: the quantity the source paper
(and Kraska et al. before it) explains learned-index performance with.
The device side lives in `repro_torch.core.plan.instrumented_expr`:
every instrumented batch returns fixed-size reductions (a log2 prediction-displacement histogram,
a rank-quantized key-space traffic histogram, bound-width and last-mile
step sums), so what crosses to the host is O(buckets) per batch, never
O(batch).  This module is the host half:

  GenerationHealth   one generation's accumulator: lifetime displacement
                     statistics (quantiles against the static ``max_err``
                     bound) plus a ring of per-time-slot traffic
                     histograms — the same lazy-recycle ring as
                     `windows.WindowedMetrics` — compared at read time
                     against the build-time key distribution.  The
                     comparison is a total-variation score: by
                     construction the build-time distribution over rank
                     buckets is UNIFORM (bucket j holds ranks
                     [j*n/K, (j+1)*n/K)), so drift is measured without
                     retaining the keys.
  HealthMonitor      version -> GenerationHealth map (bounded), fed by
                     `IndexRegistry.publish` and the executors'
                     completion paths; `snapshot()` flattens the CURRENT
                     generation's health into the alert-rule namespace.

Everything here is numpy + stdlib; the serve stack imports *us*.  A
copy of the reference's `repro.obs.health`, routed shard-group views
included, held equal to it by `tests/test_torch_obs.py` and
`tests/test_torch_topology.py`.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["GenerationHealth", "HEALTH_DISP_BUCKETS", "HEALTH_STATS_SIZE",
           "HEALTH_TRAFFIC_BUCKETS", "HealthMonitor", "fold_stats",
           "unpack_stats"]

#: Log2 displacement buckets: bucket 0 holds |pred-found| == 0, bucket j
#: holds [2^(j-1), 2^j), the last bucket overflows.  24 buckets cover
#: displacements past 4M slots — beyond any sane error bound.
HEALTH_DISP_BUCKETS = 24

#: Rank-quantized key-space traffic buckets: query rank r lands in
#: bucket r*K//n.  Build-time mass per bucket is uniform by construction.
HEALTH_TRAFFIC_BUCKETS = 64


#: Packed stats vector (what instrumented executables actually return,
#: `repro_torch.core.plan.pack_health_stats`): 5 int64 scalars
#: [n, disp_sum, disp_max, width_sum, steps_sum] then the two histograms.
HEALTH_STATS_SIZE = 5 + HEALTH_DISP_BUCKETS + HEALTH_TRAFFIC_BUCKETS


def unpack_stats(vec) -> Dict:
    """Reverse `repro_torch.core.plan.pack_health_stats`: one int64 vector
    back to the named stats dict `GenerationHealth.accumulate` folds."""
    vec = np.asarray(vec)
    if vec.shape != (HEALTH_STATS_SIZE,):
        raise ValueError(f"packed stats must be shape "
                         f"({HEALTH_STATS_SIZE},), got {vec.shape}")
    d1 = 5 + HEALTH_DISP_BUCKETS
    return {"n": int(vec[0]), "disp_sum": int(vec[1]),
            "disp_max": int(vec[2]), "width_sum": int(vec[3]),
            "steps_sum": int(vec[4]), "disp_hist": vec[5:d1],
            "traffic_hist": vec[d1:]}


def fold_stats(vecs) -> np.ndarray:
    """The packed stats vectors of one batch's slices (a broadcast over
    several cards) folded into the vector one device returns for the
    whole batch: counts, sums and histograms add, ``disp_max`` takes the
    max.  The batch's record is then the one-device record exactly."""
    vecs = [np.asarray(v, dtype=np.int64) for v in vecs]
    out = np.sum(vecs, axis=0, dtype=np.int64)
    out[2] = max(int(v[2]) for v in vecs)
    return out


def disp_bucket_edge(j: int) -> int:
    """Upper edge (inclusive) of displacement bucket ``j``: the value a
    quantile read reports for mass landing in that bucket."""
    return 0 if j == 0 else (1 << j) - 1


def build_rank_hist(n_keys: int,
                    k: int = HEALTH_TRAFFIC_BUCKETS) -> np.ndarray:
    """The build-time key-rank distribution over ``k`` buckets — exact
    integer counts of ranks per bucket (uniform up to rounding), derived
    from ``n_keys`` alone.  Ceil edges: rank ``r`` belongs to bucket
    ``r*k//n``, exactly the device-side partition in
    `plan.health_stats_expr`."""
    edges = (np.arange(k + 1, dtype=np.int64) * int(n_keys)
             + k - 1) // k
    return np.diff(edges)


class _TrafficSlot:
    """One time slot of the traffic ring: a bucket-count vector."""

    __slots__ = ("idx", "hist")

    def __init__(self, idx: int, k: int):
        self.idx = idx
        self.hist = np.zeros(k, np.int64)


class GenerationHealth:
    """Accumulated health of ONE serving generation.

    `accumulate` ingests the device-reduced stats dict of one completed
    instrumented batch (already on host, via `ShardedDispatcher.finalize`);
    `snapshot` answers displacement quantiles vs ``max_err``, mean bound
    width / last-mile steps, the windowed traffic-vs-build drift score,
    and the delta/compaction-debt gauge — the flat key namespace alert
    rules evaluate over.
    """

    def __init__(self, version: int, index: str, n_keys: int, max_err: int,
                 *, build_disp_p99: float = 0.0, slot_s: float = 0.5,
                 n_slots: int = 240, clock=time.perf_counter,
                 shard: Optional[int] = None):
        self.version = int(version)
        self.index = str(index)
        self.n_keys = int(n_keys)
        self.max_err = int(max_err)
        #: shard index inside a routed generation set (None = broadcast)
        #: — surfaces as the ``shard`` key of `/health.json` records
        self.shard = shard
        #: build-time p99 displacement of the generation's own keys
        #: (`LookupPlan.build_displacement_quantile`): the baseline the
        #: live `disp_p99_ratio` alert key is relative to
        self.build_disp_p99 = float(build_disp_p99)
        self.slot_s = float(slot_s)
        self.n_slots = int(n_slots)
        self._clock = clock
        self.t_published = clock()
        self._mu = threading.Lock()
        # lifetime displacement statistics (device-reduced, host-summed)
        self.n = 0
        self.disp_hist = np.zeros(HEALTH_DISP_BUCKETS, np.int64)
        self.disp_sum = 0
        self.disp_max = 0
        self.width_sum = 0
        self.steps_sum = 0
        # traffic: lifetime total + windowed ring (drift is windowed —
        # a shift must not be diluted by the stationary history)
        self.traffic_total = np.zeros(HEALTH_TRAFFIC_BUCKETS, np.int64)
        self._slots: List[Optional[_TrafficSlot]] = [None] * self.n_slots
        self.build_hist = build_rank_hist(self.n_keys)
        # write-side gauge (mutable service): compaction debt
        self.delta_keys = 0
        self.delta_threshold = 0

    # -- ingestion -------------------------------------------------------
    def accumulate(self, stats, t: Optional[float] = None) -> None:
        """Fold one batch's stats in — either the packed int64 vector an
        instrumented executable returns, or the named dict (tests and
        synthetic injection)."""
        if not isinstance(stats, dict):
            stats = unpack_stats(stats)
        t = self._clock() if t is None else t
        traffic = np.asarray(stats["traffic_hist"], np.int64)
        idx = int(t / self.slot_s)
        with self._mu:
            self.n += int(stats["n"])
            self.disp_hist += np.asarray(stats["disp_hist"], np.int64)
            self.disp_sum += int(stats["disp_sum"])
            self.disp_max = max(self.disp_max, int(stats["disp_max"]))
            self.width_sum += int(stats["width_sum"])
            self.steps_sum += int(stats["steps_sum"])
            self.traffic_total += traffic
            slot = self._slots[idx % self.n_slots]
            if slot is None or slot.idx != idx:
                # lazy recycle — any previous occupant is >= n_slots
                # slots old, outside every window we answer
                slot = _TrafficSlot(idx, HEALTH_TRAFFIC_BUCKETS)
                self._slots[idx % self.n_slots] = slot
            slot.hist += traffic

    def note_delta(self, delta_keys: int, threshold: int) -> None:
        with self._mu:
            self.delta_keys = int(delta_keys)
            self.delta_threshold = int(threshold)

    # -- reads -----------------------------------------------------------
    def disp_quantile(self, q: float) -> float:
        """Displacement at quantile ``q`` from the lifetime log2
        histogram, linearly interpolated within the landing bucket —
        the upper edge alone overstates coarse high buckets by up to
        2x (a p99 of 804 would read as 1023).  The overflow bucket
        reports the observed max."""
        with self._mu:
            hist, n, dmax = self.disp_hist.copy(), self.n, self.disp_max
        if n == 0:
            return 0.0
        target = q * n
        acc = 0
        for j, c in enumerate(hist):
            c = int(c)
            if c and acc + c >= target:
                if j == HEALTH_DISP_BUCKETS - 1:
                    return float(dmax)
                lo = 0 if j == 0 else (1 << (j - 1))
                frac = (target - acc) / c
                return lo + frac * (disp_bucket_edge(j) - lo)
            acc += c
        return float(dmax)

    def traffic_window(self, window_s: float,
                       t: Optional[float] = None) -> np.ndarray:
        """Merged traffic histogram over the trailing ``window_s``."""
        t = self._clock() if t is None else t
        k = max(1, min(self.n_slots, int(np.ceil(window_s / self.slot_s))))
        idx_now = int(t / self.slot_s)
        lo = idx_now - k + 1
        out = np.zeros(HEALTH_TRAFFIC_BUCKETS, np.int64)
        with self._mu:
            for slot in self._slots:
                if slot is not None and lo <= slot.idx <= idx_now:
                    out += slot.hist
        return out

    def drift(self, window_s: float = 10.0,
              t: Optional[float] = None):
        """Total-variation distance between the trailing window's traffic
        distribution and the build-time rank distribution; returns
        ``(tv, n_window)``.  TV in [0, 1]: 0 = traffic matches the build
        distribution, 1 = fully disjoint support."""
        traffic = self.traffic_window(window_s, t=t)
        n = int(traffic.sum())
        b = int(self.build_hist.sum())
        if n == 0 or b == 0:
            return 0.0, n
        tv = 0.5 * float(np.abs(traffic / n - self.build_hist / b).sum())
        return tv, n

    def snapshot(self, window_s: float = 10.0,
                 t: Optional[float] = None) -> Dict[str, float]:
        """The flat health keys of this generation — what alert rules
        and the export surfaces consume."""
        tv, n_window = self.drift(window_s, t=t)
        with self._mu:
            n = self.n
            disp_sum, disp_max = self.disp_sum, self.disp_max
            width_sum, steps_sum = self.width_sum, self.steps_sum
            delta_keys, delta_threshold = (self.delta_keys,
                                           self.delta_threshold)
        p50 = self.disp_quantile(0.50)
        p99 = self.disp_quantile(0.99)
        return {
            "generation_version": float(self.version),
            "health_n": float(n),
            "disp_mean": disp_sum / n if n else 0.0,
            "disp_p50": float(p50),
            "disp_p99": float(p99),
            "disp_max": float(disp_max),
            "build_disp_p99": self.build_disp_p99,
            # live p99 vs the SAME model's build-time p99: ~1.0 when
            # traffic exercises the keys the model was fit on, inflating
            # when it concentrates on badly-modelled regions or a grown
            # delta shifts ranks — the alertable signal
            # (bound_utilization_p99 saturates near 1.0 even when
            # healthy for eps-bounded indexes, so rules key on this)
            "disp_p99_ratio": (float(p99) / max(1.0, self.build_disp_p99)
                               if n else 0.0),
            # how much of the static error bound the live p99
            # displacement consumes: the bounded search window must span
            # [pred - d, pred + d], i.e. 2*d + 1 of the max_err budget
            "bound_utilization_p99": (min(1.0, (2.0 * p99 + 1.0)
                                          / self.max_err)
                                      if self.max_err > 0 and n else 0.0),
            "mean_bound_width": width_sum / n if n else 0.0,
            "mean_last_mile_steps": steps_sum / n if n else 0.0,
            "drift_tv": tv,
            "drift_n": float(n_window),
            "compaction_debt": (delta_keys / delta_threshold
                                if delta_threshold else 0.0),
        }

    def record(self, window_s: float = 10.0) -> Dict:
        """Registry-facing per-generation health record."""
        doc = self.snapshot(window_s)
        doc.update(index=self.index, n_keys=self.n_keys,
                   max_err=self.max_err,
                   traffic_lifetime=int(self.traffic_total.sum()))
        if self.shard is not None:
            doc["shard"] = int(self.shard)
        return doc


def _zero_snapshot() -> Dict[str, float]:
    return {
        "generation_version": -1.0, "health_n": 0.0, "disp_mean": 0.0,
        "disp_p50": 0.0, "disp_p99": 0.0, "disp_max": 0.0,
        "build_disp_p99": 0.0, "disp_p99_ratio": 0.0,
        "bound_utilization_p99": 0.0, "mean_bound_width": 0.0,
        "mean_last_mile_steps": 0.0, "drift_tv": 0.0, "drift_n": 0.0,
        "compaction_debt": 0.0,
    }


class HealthMonitor:
    """Bounded version -> `GenerationHealth` map for one registry name.

    `IndexRegistry.publish` calls `on_publish` (the monitor hangs off
    the registry like the span recorder does); the executors' completion
    paths call `accumulate(version, stats)` — a batch that completes
    against a just-retired generation still lands in ITS record, never
    the successor's.  ``keep`` bounds retained generations (compaction
    churn must not grow memory).
    """

    def __init__(self, slot_s: float = 0.5, n_slots: int = 240,
                 keep: int = 8, clock=time.perf_counter):
        self.slot_s = float(slot_s)
        self.n_slots = int(n_slots)
        self.keep = int(keep)
        self._clock = clock
        self._mu = threading.Lock()
        self._records: "collections.OrderedDict[int, GenerationHealth]" = \
            collections.OrderedDict()
        self._latest: Optional[GenerationHealth] = None
        #: versions of the live routed shard group (None = broadcast):
        #: set by `on_publish_group`, consumed by `snapshot` to merge
        self._group: Optional[tuple] = None

    # -- registry hooks ---------------------------------------------------
    def _make_record(self, gen,
                     shard: Optional[int] = None) -> GenerationHealth:
        bq = getattr(gen.plan, "build_displacement_quantile", None)
        return GenerationHealth(
            version=gen.version, index=gen.plan.name, n_keys=gen.n_keys,
            max_err=int(gen.plan.bounds.max_err),
            build_disp_p99=float(bq(0.99)) if bq is not None else 0.0,
            slot_s=self.slot_s, n_slots=self.n_slots, clock=self._clock,
            shard=shard)

    def on_publish(self, gen) -> None:
        """New generation published (duck-typed on the `Generation`
        surface: version / n_keys / plan.name / plan.bounds.max_err).
        The build-time displacement baseline is evaluated here — one
        device pass over a key sample per publish, amortized against
        the index build that just happened."""
        rec = self._make_record(gen)
        with self._mu:
            self._records[rec.version] = rec
            self._latest = rec
            self._group = None
            while len(self._records) > self.keep:
                self._records.popitem(last=False)

    def on_publish_group(self, gens) -> None:
        """Routed publish: one record PER SHARD
        generation, tagged with its shard index, plus a group marker so
        `snapshot` answers the merged view.  Per-shard records keep
        their own drift windows — a hot range shifting inside one shard
        is that shard's alert, not averaged away globally."""
        recs = [self._make_record(gen, shard=getattr(gen, "shard", s))
                for s, gen in enumerate(gens)]
        with self._mu:
            for rec in recs:
                self._records[rec.version] = rec
            self._latest = recs[-1] if recs else self._latest
            self._group = tuple(rec.version for rec in recs)
            # never trim away a member of the live shard group
            while len(self._records) > max(self.keep, len(recs)):
                ver, _ = next(iter(self._records.items()))
                if self._group is not None and ver in self._group:
                    break
                self._records.popitem(last=False)

    # -- ingestion --------------------------------------------------------
    def accumulate(self, version: int, stats,
                   t: Optional[float] = None) -> None:
        with self._mu:
            rec = self._records.get(int(version))
        if rec is not None:
            rec.accumulate(stats, t=t)

    def note_delta(self, delta_keys: int, threshold: int) -> None:
        rec = self.current()
        if rec is not None:
            rec.note_delta(delta_keys, threshold)

    # -- reads ------------------------------------------------------------
    def current(self) -> Optional[GenerationHealth]:
        with self._mu:
            return self._latest

    def get(self, version: int) -> Optional[GenerationHealth]:
        with self._mu:
            return self._records.get(int(version))

    def records(self, window_s: float = 10.0) -> List[Dict]:
        with self._mu:
            recs = list(self._records.values())
        return [r.record(window_s) for r in recs]

    def merged_snapshot(self, versions, window_s: float = 10.0
                        ) -> Dict[str, float]:
        """One flat health view over a routed shard group: displacement
        histograms and count sums merge exactly (they are plain sums of
        per-batch reductions); drift TV is the traffic-mass-weighted
        mean of per-shard TVs (each shard's window is compared against
        its OWN build distribution — a global uniform baseline would
        misread routing itself as drift)."""
        with self._mu:
            recs = [self._records.get(int(v)) for v in versions]
        recs = [r for r in recs if r is not None]
        if not recs:
            return _zero_snapshot()
        agg = GenerationHealth(
            version=max(r.version for r in recs), index=recs[0].index,
            n_keys=sum(r.n_keys for r in recs),
            max_err=max(r.max_err for r in recs),
            build_disp_p99=max(r.build_disp_p99 for r in recs),
            slot_s=self.slot_s, n_slots=1, clock=self._clock)
        tv_num, n_window = 0.0, 0
        for r in recs:
            with r._mu:
                agg.n += r.n
                agg.disp_hist += r.disp_hist
                agg.disp_sum += r.disp_sum
                agg.disp_max = max(agg.disp_max, r.disp_max)
                agg.width_sum += r.width_sum
                agg.steps_sum += r.steps_sum
            tv, nw = r.drift(window_s)
            tv_num += tv * nw
            n_window += nw
        snap = agg.snapshot(window_s)
        snap["drift_tv"] = tv_num / n_window if n_window else 0.0
        snap["drift_n"] = float(n_window)
        snap["health_shards"] = float(len(recs))
        return snap

    def global_traffic_hist(self, window_s: float = 10.0
                            ) -> Optional[np.ndarray]:
        """The trailing window's traffic histogram in GLOBAL rank space —
        the autotune retuner's workload signature / objective input.

        Broadcast: the current generation's window verbatim.  Routed
        group: each shard's local-rank histogram is re-binned into the
        global rank axis (shards ordered by shard index, offsets from
        their key counts) by landing each local bucket's mass at its
        midpoint rank — exact to within one global bucket, which is
        finer than the signature quantization consuming it.  None
        before any publish."""
        with self._mu:
            group = self._group
            latest = self._latest
        if group is None:
            return None if latest is None \
                else latest.traffic_window(window_s)
        with self._mu:
            recs = [self._records.get(int(v)) for v in group]
        recs = sorted([r for r in recs if r is not None],
                      key=lambda r: (r.shard if r.shard is not None else 0))
        if not recs:
            return None
        k = HEALTH_TRAFFIC_BUCKETS
        n_total = sum(r.n_keys for r in recs)
        merged = np.zeros(k, np.int64)
        off = 0
        for r in recs:
            local = r.traffic_window(window_s)
            edges = (np.arange(k + 1, dtype=np.int64) * r.n_keys
                     + k - 1) // k
            mids = np.minimum((edges[:-1] + edges[1:]) // 2,
                              max(0, r.n_keys - 1))
            g = np.minimum((off + mids) * k // max(1, n_total), k - 1)
            np.add.at(merged, g, local)
            off += r.n_keys
        return merged

    def snapshot(self, window_s: float = 10.0) -> Dict[str, float]:
        """The CURRENT generation's flat health keys (zeros before any
        publish, so alert rules always see their keys).  With a routed
        group live, the merged cross-shard view."""
        with self._mu:
            group = self._group
        if group is not None:
            return self.merged_snapshot(group, window_s)
        rec = self.current()
        return rec.snapshot(window_s) if rec is not None \
            else _zero_snapshot()
