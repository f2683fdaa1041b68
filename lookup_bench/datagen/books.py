"""Surrogate of SOSD's ``books_200M_uint64`` (Amazon book popularity),
until the published file is in the repository: a lognormal(10, 2.2) body
of ``1.25 n`` draws and a Pareto(1.1) tail of a twentieth as many, the
mixture of the port's numpy ``amzn`` surrogate, drawn on the device (its
shape, not its bits).

The draws are scaled so that the largest is 2^62 (`TOP`), then floored
(at least 1), sorted, deduplicated and cut to exactly ``n``.  The port's
surrogate scales to 2^47; at 200M keys that floors the body's dense part
onto far fewer integers than draws and tops the shortfall up with
uniform keys, so most keys would not be of the mixture.  At 2^62 the
draws stay distinct (`draw` gives them, for the check of that share).
"""
from __future__ import annotations

import math

import torch

from lookup_bench.keys import finalize

#: the largest key
TOP = 2.0 ** 62


def draw(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """The mixture's draws for ``n`` keys, scaled and floored (int64)."""
    m = int(n * 1.25)
    raw = torch.empty(m + m // 20, dtype=torch.float64, device=device)
    raw[:m].log_normal_(10.0, 2.2, generator=gen)
    # numpy's pareto(a) + 1 is exp(E / a) for a standard exponential E
    tail = raw[m:]
    tail.exponential_(1.0, generator=gen)
    tail.div_(1.1).exp_().mul_(math.exp(14.0))
    raw.mul_(TOP / float(raw.max())).clamp_(min=1.0)
    return raw.to(torch.int64)


def generate(n: int, gen: torch.Generator, device) -> torch.Tensor:
    return finalize(draw(n, gen, device), n, gen)
