"""Workload-aware tuning objective.

The stock `Tuner` ranks ladder rungs by `analysis.cost_ns` over a
uniform probe stream — the paper's setting, where queries hit the key
space evenly and the mean is the story.  Live traffic is neither: the
health layer's 64-bucket histogram says *where* queries actually land,
the profiler's ``cost_model_ratio`` says how far the proxy is from
measured reality, and the windowed SLO burn says the *tail*, not the
mean, is what pages.  This objective folds all three into the Tuner
through its plug-in point:

- **traffic weighting** enters through the probe stream itself:
  `workload_queries` samples query ranks from the traffic histogram, so
  every per-rung ``widths`` measurement — and therefore every metric
  the cost model sees — is already weighted by where traffic lands.
  An index family whose error balloons exactly under the hot spot pays
  for it; one that is tight there is rewarded.
- **calibration** rescales each family's proxy cost by the measured
  ``cost_model_ratio`` before cross-family ranking (satellite fix: a
  2x-miscalibrated proxy must not flip the choice).
- **tail pressure** adds a p99-width term: the extra last-mile probe
  rounds a p99-wide window needs beyond the mean-width window, at the
  proxy's per-probe price, scaled by ``tail_weight`` (derived from the
  live SLO burn — the hotter the burn, the more the tail dominates the
  score).

A copy of the reference's `repro.autotune.objective` over the port's
`repro_torch.core.analysis` (the same cost weights).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.core import analysis

#: proxy ns for ONE extra dependent last-mile probe round
#: (1 probe + 8 bytes + 2 flops at the cost model's weights)
_PER_PROBE_NS = (analysis.COST_NS_WEIGHTS["probes"]
                 + 8 * analysis.COST_NS_WEIGHTS["bytes_touched"]
                 + 2 * analysis.COST_NS_WEIGHTS["flops"])


def tail_weight_from_burn(slo_burn: float) -> float:
    """Map the windowed SLO error-budget burn to a tail weight: 1.0 at
    zero burn (mean and tail count equally), saturating at 5.0 so one
    pathological window cannot make the tail term the whole objective."""
    return 1.0 + min(4.0, max(0.0, float(slo_burn)))


def workload_queries(keys: np.ndarray,
                     traffic_hist: Optional[np.ndarray],
                     n: int, seed: int = 0,
                     absent_frac: float = 0.25) -> np.ndarray:
    """Probe stream drawn from the live traffic histogram.

    Buckets are the health layer's equal-rank-count partition (the same
    ceil-edge formula as ``obs.health.build_rank_hist``, so bucket j
    here is exactly bucket j there); a bucket is drawn proportional to
    its traffic mass, then a rank uniformly inside it.  A fixed
    ``absent_frac`` of the stream is absent keys uniform over the key
    range — lower-bound semantics on misses must stay in the objective
    or the tuner would overfit to the present-key fast path.
    Zero/None histogram → uniform ranks (cold-start behaviour matches
    the stock tuner's probe mix).
    """
    rng = np.random.default_rng(seed)
    keys = np.asarray(keys, dtype=np.uint64)
    n_keys = len(keys)
    n = max(64, int(n))
    n_absent = int(n * absent_frac)
    n_present = n - n_absent

    hist = None if traffic_hist is None else np.asarray(
        traffic_hist, dtype=np.float64)
    if hist is None or hist.size == 0 or float(hist.sum()) <= 0:
        ranks = rng.integers(0, n_keys, n_present)
    else:
        k = hist.size
        p = hist / hist.sum()
        edges = (np.arange(k + 1, dtype=np.int64) * n_keys + k - 1) // k
        buckets = rng.choice(k, size=n_present, p=p)
        lo = edges[buckets]
        hi = np.maximum(edges[buckets + 1], lo + 1)   # empty-bucket guard
        ranks = (lo + rng.random(n_present) * (hi - lo)).astype(np.int64)
        ranks = np.clip(ranks, 0, n_keys - 1)
    present = keys[ranks]
    absent = rng.integers(int(keys[0]),
                          max(int(keys[-1]), int(keys[0]) + 1),
                          n_absent, dtype=np.uint64)
    return np.concatenate([present, absent])


@dataclasses.dataclass
class WorkloadObjective:
    """Duck-typed `Tuner.objective`: workload-drawn probes + calibrated,
    tail-weighted scoring.  Also reused by the retuner to score the
    *incumbent* build under identical terms (same queries, same
    calibration, same tail weight) so the win-margin comparison is
    apples to apples."""

    traffic_hist: Optional[np.ndarray] = None
    calibration: Any = None          # None | float | {index_name: ratio}
    tail_weight: float = 1.0
    n_queries: int = 2048
    seed: int = 0
    absent_frac: float = 0.25

    # -- Tuner plug-in protocol -----------------------------------------
    def queries(self, keys: np.ndarray) -> np.ndarray:
        return workload_queries(keys, self.traffic_hist, self.n_queries,
                                seed=self.seed,
                                absent_frac=self.absent_frac)

    def score(self, spec: Any, metrics: Dict[str, Any],
              widths: np.ndarray) -> float:
        """Calibrated mean proxy + tail term from the width quantiles."""
        cal = self._calibration_for(getattr(spec, "index", None))
        mean_cost = analysis.cost_ns(metrics, calibration=cal)
        w = np.asarray(widths, dtype=np.float64)
        if w.size:
            p99_w = float(np.quantile(w, 0.99))
        else:
            p99_w = float(metrics.get("avg_width", 1.0))
        extra = self._probe_rounds(p99_w) - self._probe_rounds(
            float(metrics.get("avg_width", 1.0)))
        tail = max(0.0, extra) * _PER_PROBE_NS * cal
        return float(mean_cost + self.tail_weight * tail)

    # -- helpers ---------------------------------------------------------
    @staticmethod
    def _probe_rounds(width: float) -> float:
        """Binary-search rounds a last-mile window of ``width`` takes."""
        return math.ceil(math.log2(max(2.0, width)))

    def _calibration_for(self, index: Optional[str]) -> float:
        if self.calibration is None:
            return 1.0
        if isinstance(self.calibration, (int, float)):
            return float(self.calibration)
        return float(self.calibration.get(index, 1.0))

    def describe(self) -> Dict[str, Any]:
        """Compact JSON-able summary for decision records."""
        hist = self.traffic_hist
        return {
            "tail_weight": self.tail_weight,
            "n_queries": self.n_queries,
            "traffic_buckets": None if hist is None else int(
                np.asarray(hist).size),
            "calibration": (self.calibration
                            if self.calibration is None
                            or isinstance(self.calibration, (int, float))
                            else {k: round(float(v), 4)
                                  for k, v in self.calibration.items()}),
        }
