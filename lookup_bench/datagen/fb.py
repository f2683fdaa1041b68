"""Surrogate of SOSD's ``fb_200M_uint64`` (Facebook user IDs), until the
published file is in the repository: the shape of the port's numpy
``face`` surrogate, drawn on the device (its shape, not its bits).

A body of ``1.05 (n - OUTLIERS)`` IDs drawn uniform in ``[1, 2^50)``,
cut to ``n - OUTLIERS`` distinct keys, and `OUTLIERS` distinct IDs drawn
uniform in ``[2^59, 2^63 - 1)``: the file's few extreme IDs, which
stretch the key range so far that a radix table over ``[kmin, kmax]``
puts the whole body into a few buckets.  The port's surrogate draws its
outliers up to 2^64; the benchmark's keys lie below 2^63, so these stop
there.  The outliers are cut on their own and kept whole.
"""
from __future__ import annotations

import torch

from lookup_bench.keys import finalize

#: extreme IDs among the keys
OUTLIERS = 100
#: the body's IDs lie below this
BODY_TOP = 1 << 50
#: the outliers' IDs lie in [OUTLIER_LO, OUTLIER_HI)
OUTLIER_LO, OUTLIER_HI = 1 << 59, (1 << 63) - 1


def draw(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """The IDs drawn for ``n`` keys (int64), repeats included: the
    body's draws, then the last `OUTLIERS` the outliers'."""
    m = int((n - OUTLIERS) * 1.05)
    raw = torch.empty(m + OUTLIERS, dtype=torch.int64, device=device)
    raw[:m].random_(1, BODY_TOP, generator=gen)
    raw[m:].random_(OUTLIER_LO, OUTLIER_HI, generator=gen)
    return raw


def generate(n: int, gen: torch.Generator, device) -> torch.Tensor:
    raw = draw(n, gen, device)
    body = finalize(raw[:-OUTLIERS], n - OUTLIERS, gen)
    outliers = finalize(raw[-OUTLIERS:], OUTLIERS, gen)
    del raw
    return torch.cat([body, outliers])
