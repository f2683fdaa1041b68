"""Surrogate of SOSD's ``wiki_ts_200M_uint64`` (Wikipedia edit
timestamps, Unix seconds), until the published file is in the
repository: the arrival process of the port's numpy ``wiki`` surrogate,
drawn on the device (its shape, not its bits), in whole seconds from
10^9 (2001-09).

``1.4 n`` exponential gaps of mean `GAP_S` over a rate ``1 + 0.8
sin^2(2 pi i / 86400)`` of the draw ``i``, raised by exponential(50)
bursts at a two-hundredth of the draws, are summed and floored to
seconds; about a quarter of the draws repeat a second, and the distinct
seconds are cut to exactly ``n`` (the port's ``load_real`` keeps the
published file's distinct keys too).  At 200M keys they span about
5.2e8 s, to 2018.  The gaps are summed in fixed point (2^-20 s): an
integer prefix sum is the same in any order, where the card's float scan
is not, so a seed gives the same keys on every run.
"""
from __future__ import annotations

import math

import torch

from lookup_bench.keys import finalize

#: seconds, the mean gap at rate 1
GAP_S = 2.5
#: the first timestamp
START = 10 ** 9


def draw(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """The timestamps drawn for ``n`` keys, repeats included (int64)."""
    m = int(n * 1.4)
    rate = torch.arange(m, dtype=torch.float64, device=device)
    rate.mul_(2 * math.pi / 86400.0).sin_().square_().mul_(0.8).add_(1.0)
    burst_at = torch.randperm(m, generator=gen, device=device)[:m // 200]
    burst = torch.empty(burst_at.shape[0], dtype=torch.float64,
                        device=device).exponential_(1.0 / 50.0,
                                                    generator=gen)
    rate.index_add_(0, burst_at, burst)
    del burst_at, burst
    gaps = torch.empty(m, dtype=torch.float64, device=device)
    gaps.exponential_(1.0, generator=gen).div_(rate).mul_(GAP_S * 2 ** 20)
    del rate
    ts = torch.cumsum(gaps.round_().to(torch.int64), 0)
    del gaps
    return ts.bitwise_right_shift_(20).add_(START)


def generate(n: int, gen: torch.Generator, device) -> torch.Tensor:
    return finalize(draw(n, gen, device), n, gen)
