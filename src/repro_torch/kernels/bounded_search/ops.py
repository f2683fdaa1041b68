"""`lower_bound_windows`: the exact bounded last mile, kernel or plain.

A CUDA tensor goes to the hand-written kernel (``csrc/bounded_search.cu``)
and nowhere else; a CPU tensor goes to `lower_bound_windows_plain`, the
same search written as torch ops.  Both return the same int32 ranks for
every input.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bounded_search import kernel
from repro_torch.kernels.common import branchless_lower_bound, lb_steps


def lower_bound_windows_plain(data, queries, lo, max_width: int):
    """`branchless_lower_bound` in int32 over ``[lo, min(lo+W, n) - 1]``,
    ``lo`` clipped to ``[0, n-1]``."""
    n = data.shape[0]
    if n == 0:
        return torch.zeros(queries.shape[0], dtype=torch.int32,
                           device=queries.device)
    lo64 = torch.clamp(lo.to(torch.int64), 0, n - 1)
    hi = torch.clamp(lo64 + int(max_width), max=n) - 1
    return branchless_lower_bound(
        data, queries, lo64.to(torch.int32), hi.to(torch.int32), max_width,
        index_dtype=torch.int32)


def lower_bound_windows(data, queries, lo, max_width: int):
    """Exact LB(q) for every query, as int32.

    ``data`` [n] and ``queries`` [m] are encoded keys (`kernels.common`);
    ``lo`` [m] are window starts with the precondition
    ``lo <= LB < lo + max_width`` (``lo`` is clipped to ``[0, n-1]``).
    """
    n = data.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"n={n} keys: int32 ranks need n < 2^31")
    if data.device.type == "cpu":
        return lower_bound_windows_plain(data, queries, lo, max_width)
    if n == 0:
        return torch.zeros(queries.shape[0], dtype=torch.int32,
                           device=queries.device)
    return kernel.launch(data, queries, lo, max_width, lb_steps(max_width))
