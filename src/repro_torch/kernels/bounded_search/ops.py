"""`lower_bound_windows`: the exact bounded last mile, kernel or plain.

A CUDA tensor goes to the hand-written kernel (``csrc/bounded_search.cu``)
and nowhere else; a CPU tensor goes to `lower_bound_windows_plain`, the
same search written as torch ops.  Both return the same int32 ranks for
every input.

Each query searches its own window, ``[clip(lo, 0, n-1), min(hi, lo +
max_width - 1, n)]`` with position ``n`` as +inf (``hi`` inclusive and
optional), and stops when the window is empty.  The result is ``lo`` plus
the count of keys below ``q`` in the window, which is what the TPU kernel
counts, and the exact LB wherever the window holds it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bounded_search import kernel


def clip_windows(n: int, lo, max_width: int, hi=None):
    """Each query's window as int64 ``(start, count)``."""
    start = torch.clamp(lo.to(torch.int64), 0, n - 1)
    last = start + (int(max_width) - 1)
    if hi is not None:
        last = torch.minimum(last, hi.to(torch.int64))
    last = torch.clamp(last, max=n)
    return start, torch.clamp(last - start + 1, min=0)


def window_probes(count):
    """``ceil(log2(count + 1))``: the probes a window of ``count``
    positions costs the search, exactly (the bit length of ``count``)."""
    probes = torch.zeros_like(count)
    c = count.clone()
    while bool((c > 0).any()):
        probes += (c > 0).to(probes.dtype)
        c >>= 1
    return probes


def lower_bound_windows_plain(data, queries, lo, max_width: int, hi=None):
    """The kernel's search as torch ops: every query steps while its own
    window is non-empty (masked lanes hold still)."""
    n = data.shape[0]
    if n == 0:
        return torch.zeros(queries.shape[0], dtype=torch.int32,
                           device=queries.device)
    pos, count = clip_windows(n, lo, max_width, hi)
    for _ in range(min(max(int(max_width), 0), n + 1).bit_length()):
        step = count // 2
        idx = pos + step
        probe = data[torch.clamp(idx, max=n - 1)]
        right = (probe < queries) & (idx < n) & (count > 0)
        pos = torch.where(right, idx + 1, pos)
        count = torch.where(right, count - step - 1, step)
    return pos.to(torch.int32)


def lower_bound_windows(data, queries, lo, max_width: int, hi=None):
    """Exact LB(q) for every query, as int32.

    ``data`` [n] and ``queries`` [m] are encoded keys (`kernels.common`)
    or both int32 (the KV cache's slot index);
    ``lo`` [m] (and ``hi`` [m], inclusive, if given) bound windows that
    hold LB: ``lo <= LB <= min(hi, lo + max_width - 1)``.
    """
    n = data.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"n={n} keys: int32 ranks need n < 2^31")
    if data.device.type == "cpu":
        return lower_bound_windows_plain(data, queries, lo, max_width, hi)
    if n == 0:
        return torch.zeros(queries.shape[0], dtype=torch.int32,
                           device=queries.device)
    return kernel.launch(data, queries, lo, max_width, hi)
