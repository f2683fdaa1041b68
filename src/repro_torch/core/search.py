"""Vectorized "last mile" searches (paper §2 / §4.2.3) as torch ops.

Each function locates ``LB(q)`` inside a search bound ``[lo, hi]`` (hi
inclusive) produced by an index; ``data`` and ``q`` are encoded keys
(`repro_torch.kernels.common`).  All are branchless with fixed trip
counts, vectorized over a query batch, so the result is the exact LB
whatever the data: the searches differ only in how many probes they make.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import branchless_lower_bound, keys_to_f64


def bounded_binary(data, q, lo, hi, max_width: int, side: str = "left"):
    """Branchless lower/upper bound in [lo, hi] (hi inclusive), int64
    positions; ``max_width`` bounds ``hi - lo + 1`` and fixes the trip
    count."""
    return branchless_lower_bound(
        data, q, lo, hi, max_width, side=side, index_dtype=torch.int64)


def bounded_linear(data, q, lo, hi, max_width: int, chunk: int = 4096):
    """Vector "linear search": gather the whole window, count keys < q.

    The window has static width (next multiple of 128 >= max_width);
    windows wider than ``chunk`` are counted chunk by chunk to bound the
    materialized gather.
    """
    del hi
    n = data.shape[0]
    lo = lo.to(torch.int64)
    width = int(np.ceil(max(1, int(max_width)) / 128.0)) * 128
    offs = torch.arange(min(width, chunk), dtype=torch.int64, device=lo.device)

    def count_chunk(start_off):
        idx = lo[:, None] + start_off + offs[None, :]
        window = data[torch.clamp(idx, 0, n - 1)]
        # out-of-bounds entries compare as +inf
        less = (window < q[:, None]) & (idx < n)
        return less.sum(dim=-1, dtype=torch.int64)

    total = torch.zeros_like(lo)
    for i in range((width + chunk - 1) // chunk):
        total = total + count_chunk(i * chunk)
    return lo + total


def bounded_interpolation(data, q, lo, hi, max_width: int, iters: int = 2):
    """Interpolation probes (float64) shrink [lo, hi]; binary finishes."""
    n = data.shape[0]
    lo = lo.to(torch.int64)
    hi = torch.maximum(hi.to(torch.int64), lo)
    qf = keys_to_f64(q)

    for _ in range(iters):
        dlo = keys_to_f64(data[torch.clamp(lo, 0, n - 1)])
        dhi = keys_to_f64(data[torch.clamp(hi, 0, n - 1)])
        denom = dhi - dlo
        frac = torch.where(
            denom > 0, (qf - dlo) / torch.where(denom == 0, 1.0, denom), 0.5)
        frac = torch.clamp(frac, 0.0, 1.0)
        span = torch.clamp(hi - lo, min=0)
        step = torch.round(frac * (hi - lo).to(torch.float64)).to(torch.int64)
        mid = lo + torch.minimum(torch.clamp(step, min=0), span)
        probe = data[torch.clamp(mid, 0, n - 1)]
        probe_lt = (probe < q) & (mid < n)
        lo = torch.where(probe_lt, mid + 1, lo)
        hi = torch.where(probe_lt, hi, mid)

    return bounded_binary(data, q, lo, hi, max_width)


SEARCH_FNS = {
    "binary": bounded_binary,
    "linear": bounded_linear,
    "interpolation": bounded_interpolation,
}


def fused_lookup_fn(build, data, last_mile: str = "binary",
                    backend: str = "torch"):
    """Lower ``build`` to a `LookupPlan` over encoded ``data`` and compile
    it: the callable maps encoded queries to int64 LB ranks."""
    from repro_torch.core import plan as plan_mod

    return plan_mod.lower(build, data, last_mile=last_mile).compile(
        backend=backend)


def full_binary(data, q):
    """Unbounded baseline (the paper's BS, size == 0)."""
    n = data.shape[0]
    lo = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    hi = torch.full(q.shape, n - 1, dtype=torch.int64, device=q.device)
    return bounded_binary(data, q, lo, hi, max_width=n)
