"""Per-plan-stage timing: predict vs bounded search.

The source paper's §4.3 contribution is *explanatory*: lookup latency
decomposes into model inference (data movement through index state) and
last-mile probes, and no single metric explains both.  The plan IR makes
the two stages first-class (`BoundsStage.predict` -> backend last mile),
so they are measured apart on live plans:

  measured   time the plan's torch predict alone and the full plan
             callable on the same query batch; the difference is the
             bounded-search stage (best of k, CUDA events on the card,
             the host clock on the CPU).  A fused ``cuda`` path (RMI's,
             PGM's) is one kernel for both stages, so its search stage is
             that difference too (total minus the standalone torch
             predict, clamped at 0), not a split inside the kernel.
  proxy      `repro_torch.core.analysis.describe`/`cost_ns` split along
             the same seam: the last-mile term is the probes, bytes and
             flops attributable to the bounded search, the remainder is
             model inference.

`profile_generation` reports both per (index, backend) cell, with
`cost_model_ratio` (measured total / proxy total).

The port of the reference's `repro.obs.profiler`.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels.common import encode_keys

__all__ = ["profile_plan", "profile_generation", "proxy_decomposition",
           "time_fn_s"]


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def time_fn_s(fn, *args, repeats: int = 3) -> float:
    """Best-of-k time of one call, seconds, after a warm call.  On a CUDA
    device each call sits between two CUDA events on the current stream
    (the device time of the work it enqueues); on the CPU it is the host
    clock around the call."""
    dev = _device_of(args)
    fn(*args)
    best = float("inf")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(max(1, repeats)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        fn(*args)
        best = min(best, time.perf_counter() - t0)
    return best


def profile_plan(plan, q, backend: str = "torch",
                 repeats: int = 3) -> Dict[str, float]:
    """Measured per-lookup stage decomposition of one `LookupPlan`.

    ``q`` is a uint64 query batch.  Returns ns/lookup for the predict
    stage, the bounded-search stage (total - predict, clamped at 0), and
    the total.  Point-only plans have no search stage by construction.
    """
    qt = encode_keys(np.asarray(q, dtype=np.uint64), plan.data.device)
    m = int(qt.shape[0])
    full = plan.compile(backend=backend)
    total_s = time_fn_s(full, qt, repeats=repeats)
    if plan.point_only:
        predict_s = total_s
    else:
        state, predict = plan.bounds.state, plan.bounds.predict
        predict_s = time_fn_s(lambda qq: predict(state, qq), qt,
                              repeats=repeats)
    total_ns = total_s / m * 1e9
    predict_ns = min(predict_s / m * 1e9, total_ns)
    return {
        "backend": backend,
        "n_queries": m,
        "stage_predict_ns": predict_ns,
        "stage_search_ns": max(0.0, total_ns - predict_ns),
        "stage_total_ns": total_ns,
        "stage_predict_frac": predict_ns / total_ns if total_ns else 0.0,
    }


def proxy_decomposition(build, widths: np.ndarray) -> Dict[str, float]:
    """The `analysis.cost_ns` proxy split along the same predict/search
    seam: the last-mile term is the probe/byte/flop cost `describe`
    attributes to the bounded search, the remainder model inference."""
    from repro_torch.core import analysis

    metrics = analysis.describe(build, np.asarray(widths))
    total = analysis.cost_ns(metrics)
    lm = int(math.ceil(math.log2(max(2.0, metrics["avg_width"]))))
    w = analysis.COST_NS_WEIGHTS
    # describe() adds per last-mile probe: 1 probe round, 8 bytes, 2 flops
    search = lm * (w["probes"] + 8 * w["bytes_touched"] + 2 * w["flops"])
    search = min(search, total)
    return {
        "proxy_predict_ns": total - search,
        "proxy_search_ns": search,
        "proxy_total_ns": total,
        "avg_width": float(metrics["avg_width"]),
    }


def profile_generation(gen, q, repeats: int = 3,
                       backend: Optional[str] = None) -> Dict[str, float]:
    """Stage decomposition of one serving `Generation`: measured split
    for the backend it serves with, proxy split from its build, and the
    measured/proxy ratio that calibrates the Tuner's cost model."""
    backend = gen.backend if backend is None else backend
    row = profile_plan(gen.plan, q, backend=backend, repeats=repeats)
    row["index"] = gen.plan.name
    if not gen.plan.point_only:
        state, predict = gen.plan.bounds.state, gen.plan.bounds.predict
        qt = encode_keys(np.asarray(q, dtype=np.uint64), gen.plan.data.device)
        lo, hi = predict(state, qt)
        widths = (hi.cpu().numpy().astype(np.int64)
                  - lo.cpu().numpy().astype(np.int64) + 1)
        row.update(proxy_decomposition(gen.build, widths))
        row["cost_model_ratio"] = (
            row["stage_total_ns"] / row["proxy_total_ns"]
            if row["proxy_total_ns"] else 0.0)
    return row
