"""Histograms and rolling-window metrics.

`LatencyHistogram` is the one latency-distribution primitive every
metrics surface shares: log-spaced buckets (fixed memory, ~5% bucket
resolution), O(log n_buckets) record via bisect — it runs under the
metrics lock on every batch completion, on the very hot path it is
supposed to measure — and mergeable counts so windowed sub-histograms
sum into exactly the histogram a flat recording would have produced.

`WindowedMetrics` answers the question lifetime aggregates cannot: *what
is the p99 right now?*  It keeps a ring of per-time-slot sub-histograms;
`record()` lands in the current slot (lazily recycling whatever stale
slot occupied its ring position), and `snapshot(window_s=...)` merges
the slots covering the trailing window at read time.  A mid-run p99
shift is visible within one slot width, while the lifetime histogram —
dominated by history — hides it.  With an SLO target configured, each
slot also counts target violations, so the snapshot reports the
error-budget burn rate of the *window*, not of all time.

Stdlib only: a copy of the reference's `repro.obs.windows`, held equal
to it by `tests/test_torch_obs.py`.
"""
from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Dict, List, Optional

__all__ = ["LatencyHistogram", "WindowedMetrics"]


class LatencyHistogram:
    """Log-spaced histogram over [1us, ~84s), growth factor 1.05."""

    def __init__(self, lo_s: float = 1e-6, factor: float = 1.05,
                 n_buckets: int = 360):
        self.lo_s = lo_s
        self.factor = factor
        self.bounds: List[float] = []
        b = lo_s
        for _ in range(n_buckets):
            self.bounds.append(b)
            b *= factor
        self.counts = [0] * (n_buckets + 1)
        self.n = 0
        self.total_s = 0.0

    def bucket_index(self, seconds: float) -> int:
        """Index of the bucket holding ``seconds``: the first i with
        ``seconds < bounds[i]`` (== number of bounds <= seconds), i.e.
        `bisect_right` over the sorted bounds; len(bounds) = overflow."""
        return bisect.bisect_right(self.bounds, seconds)

    def record(self, seconds: float) -> None:
        self.counts[self.bucket_index(seconds)] += 1
        self.n += 1
        self.total_s += seconds

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile (0 if empty)."""
        if self.n == 0:
            return 0.0
        target = q * self.n
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return self.bounds[i] if i < len(self.bounds) else float("inf")
        return self.bounds[-1]

    @property
    def mean(self) -> float:
        return self.total_s / self.n if self.n else 0.0

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Add ``other``'s counts in place (same bucketization required).
        Summing counts commutes with recording, so merged sub-histograms
        are exactly the flat histogram of the union of observations."""
        if (other.lo_s != self.lo_s or other.factor != self.factor
                or len(other.bounds) != len(self.bounds)):
            raise ValueError("cannot merge histograms with different buckets")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.n += other.n
        self.total_s += other.total_s
        return self


class _Slot:
    """One time slot of the window ring: a sub-histogram + counters."""

    __slots__ = ("idx", "hist", "units", "violations")

    def __init__(self, idx: int):
        self.idx = idx                    # absolute slot number (t // slot_s)
        self.hist = LatencyHistogram()
        self.units = 0                    # caller-defined weight (e.g. keys)
        self.violations = 0               # observations above the SLO target


class WindowedMetrics:
    """Ring of per-slot sub-histograms, merged at read.

    ``slot_s`` is the time resolution (a p99 shift becomes visible
    within one slot); ``n_slots`` bounds memory and the largest
    answerable window (``slot_s * n_slots``).  ``slo_p99_ms`` configures
    the latency target: each observation above it burns error budget,
    where the budget is the ``slo_budget`` fraction of observations
    allowed over target (default 1%, the complement of a p99 SLO).
    A burn rate of 1.0 means the window is consuming its budget exactly
    at the sustainable rate; above it, the SLO will be violated.
    """

    def __init__(self, slot_s: float = 0.5, n_slots: int = 240,
                 slo_p99_ms: Optional[float] = None,
                 slo_budget: float = 0.01,
                 clock=time.perf_counter):
        if slot_s <= 0 or n_slots < 1:
            raise ValueError("need slot_s > 0 and n_slots >= 1")
        if not 0 < slo_budget < 1:
            raise ValueError("slo_budget must be in (0, 1)")
        self.slot_s = float(slot_s)
        self.n_slots = int(n_slots)
        self.slo_p99_ms = slo_p99_ms
        self.slo_budget = float(slo_budget)
        self._clock = clock
        self._mu = threading.Lock()
        self._slots: List[Optional[_Slot]] = [None] * self.n_slots

    @property
    def max_window_s(self) -> float:
        return self.slot_s * self.n_slots

    def record(self, seconds: float, units: int = 1,
               t: Optional[float] = None) -> None:
        """One latency observation at time ``t`` (defaults to now, on
        the same clock the serve path stamps completions with)."""
        t = self._clock() if t is None else t
        idx = int(t / self.slot_s)
        with self._mu:
            slot = self._slots[idx % self.n_slots]
            if slot is None or slot.idx != idx:
                # recycle lazily: the ring position's previous occupant is
                # at least n_slots slots old, outside every window we serve
                slot = _Slot(idx)
                self._slots[idx % self.n_slots] = slot
            slot.hist.record(seconds)
            slot.units += int(units)
            if (self.slo_p99_ms is not None
                    and seconds * 1e3 > self.slo_p99_ms):
                slot.violations += 1

    def merged(self, window_s: float, t: Optional[float] = None):
        """Merge the slots covering the trailing ``window_s``; returns
        ``(hist, units, violations, covered_window_s)``."""
        t = self._clock() if t is None else t
        k = max(1, min(self.n_slots, math.ceil(window_s / self.slot_s)))
        idx_now = int(t / self.slot_s)
        lo = idx_now - k + 1
        hist = LatencyHistogram()
        units = violations = 0
        with self._mu:
            for slot in self._slots:
                if slot is not None and lo <= slot.idx <= idx_now:
                    hist.merge(slot.hist)
                    units += slot.units
                    violations += slot.violations
        return hist, units, violations, k * self.slot_s

    def snapshot(self, window_s: float = 10.0,
                 t: Optional[float] = None) -> Dict[str, float]:
        """Quantiles, rates, and SLO state of the trailing window."""
        hist, units, violations, covered = self.merged(window_s, t=t)
        viol_rate = violations / hist.n if hist.n else 0.0
        return {
            "window_s": covered,
            "n": hist.n,
            "units": units,
            "units_per_s": units / covered if covered else 0.0,
            "mean_ms": hist.mean * 1e3,
            "p50_ms": hist.quantile(0.50) * 1e3,
            "p99_ms": hist.quantile(0.99) * 1e3,
            "slo_p99_target_ms": (self.slo_p99_ms
                                  if self.slo_p99_ms is not None else 0.0),
            "slo_violations": violations,
            "slo_violation_rate": viol_rate,
            # budget burn: violation rate / allowed rate.  1.0 = burning
            # exactly at the sustainable pace; > 1.0 = SLO at risk.
            "slo_budget_burn": (viol_rate / self.slo_budget
                                if self.slo_p99_ms is not None else 0.0),
        }
