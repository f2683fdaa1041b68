"""Explanatory analysis (paper §4.3): descriptive metrics of a build.

The paper regresses lookup latency on hardware counters (cache misses,
branch misses, instructions).  These model-derived equivalents stand in
for them, computed from a build's hyperparameters and ``meta`` and the
widths of its search windows on a probe stream:

  bytes_touched   bytes of index state + data window gathered per lookup
                  (the memory-traffic analogue of cache misses)
  probes          dependent gather rounds (levels + last-mile trips,
                  the latency-chain analogue of pointer hops)
  flops           arithmetic per lookup (instruction-count analogue)
  log2_err        the paper's log2 of bound width
  size_bytes      the paper's model size

``regress`` reproduces the paper's multi-metric linear regression with
standardized coefficients and R².  Numpy only: a copy of the reference's
`repro.core.analysis`, held equal to it by `tests/test_torch_tuner.py`.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core import base


def describe(build: base.IndexBuild, widths: np.ndarray) -> Dict:
    """Per-lookup descriptive metrics for one built index."""
    name = build.name
    h = build.hyper
    levels = build.meta.get("levels", 1)
    avg_width = float(np.mean(widths))
    log2_err = float(np.mean(np.log2(np.maximum(widths, 1))))

    # bytes of index state the lookup path touches (model inference)
    if name == "rmi":
        inference_bytes = 2 * 8 + 3 * 8  # stage1 coeffs + one stage2 row
        flops = 8
    elif name == "pgm":
        inference_bytes = levels * 3 * 8 + build.meta.get("segments", 0) // max(
            build.meta.get("segments", 1), 1)
        flops = levels * 6 + levels * int(np.ceil(np.log2(h.get("eps_internal", 8) + 2))) * 2
    elif name == "radix_spline":
        inference_bytes = 2 * 8 + 4 * 8
        flops = 10 + int(np.ceil(np.log2(build.meta.get("radix_max_gap", 2) + 2))) * 2
    elif name in ("btree", "ibtree"):
        # identical node layout; ibtree's interpolation probe swaps the
        # node-wide rank count for one multiply + the same node gather
        inference_bytes = levels * (h.get("fanout", 128) + 1) * 8
        flops = (levels * (h.get("fanout", 128) + 1) if name == "btree"
                 else levels * 8)
    elif name == "rbs":
        inference_bytes = 2 * 8
        flops = 3
    else:  # binary_search
        inference_bytes = 0
        flops = 0

    last_mile_probes = int(np.ceil(np.log2(max(2, avg_width))))
    bytes_touched = inference_bytes + last_mile_probes * 8
    return {
        "name": name,
        "size_bytes": build.size_bytes,
        "log2_err": log2_err,
        "avg_width": avg_width,
        "probes": levels + last_mile_probes,
        "bytes_touched": bytes_touched,
        "flops": flops + last_mile_probes * 2,
    }


#: Per-unit latency weights turning the metrics into one scalar
#: nanosecond PROXY: a dependent probe round costs a memory-latency-ish
#: 30ns, a byte of traffic 0.25ns, a flop 0.5ns.  The absolute scale is
#: nominal (the tuner only ranks candidates and compares against a
#: caller-chosen ``target_ns`` in the same units); the RATIOS encode the
#: paper's §4.3 finding that data movement dominates, instruction count
#: least.
COST_NS_WEIGHTS = {"probes": 30.0, "bytes_touched": 0.25, "flops": 0.5}


def cost_ns(metrics: Dict, calibration: float = 1.0) -> float:
    """Scalar per-lookup latency proxy of one `describe()` record, the
    objective `repro_torch.core.spec.Tuner` minimizes or budgets against.

    ``calibration`` is a measured/proxy ratio: the proxy trusts its
    nominal weights only up to a per-index-family constant, so a live
    measurement can rescale a family's proxy before cross-family
    ranking.  1.0 = trust the proxy.
    """
    return float(calibration) * float(
        sum(w * metrics[k] for k, w in COST_NS_WEIGHTS.items()))


def regress(records: List[Dict], y_key: str = "ns_per_lookup",
            x_keys=("bytes_touched", "probes", "flops")) -> Dict:
    """Standardized linear regression of latency on metrics (paper §4.3)."""
    y = np.array([r[y_key] for r in records], np.float64)
    X = np.array([[r[k] for k in x_keys] for r in records], np.float64)
    Xs = (X - X.mean(0)) / np.maximum(X.std(0), 1e-12)
    ys = (y - y.mean()) / max(y.std(), 1e-12)
    A = np.concatenate([Xs, np.ones((len(y), 1))], axis=1)
    coef, *_ = np.linalg.lstsq(A, ys, rcond=None)
    pred = A @ coef
    ss_res = float(((ys - pred) ** 2).sum())
    ss_tot = float((ys**2).sum())
    r2 = 1.0 - ss_res / max(ss_tot, 1e-12)
    return {
        "r2": r2,
        "coef": {k: float(c) for k, c in zip(x_keys, coef[:-1])},
        "n": len(records),
    }


def single_metric_r2(records: List[Dict], y_key: str = "ns_per_lookup") -> Dict:
    """R² of each metric alone: the paper's 'no single metric explains it'."""
    out = {}
    for k in ("size_bytes", "log2_err", "bytes_touched", "probes", "flops"):
        out[k] = regress(records, y_key=y_key, x_keys=(k,))["r2"]
    return out
