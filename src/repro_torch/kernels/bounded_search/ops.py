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

The search (`search_windows_plain`, ``lookup.cuh``'s ``window_lower_bound``
step for step) first probes near the window's midpoint, where a learned
model's prediction sits: the midpoint, the edge of its 32-byte sector, and
up to ``near_blocks`` sectors further out, then the balanced search over
what is left.  B1 walks out no further than the midpoint's own sector on
int64 keys and not at all on int32 keys, the fused ``rmi_lookup`` one sector
further (`NEAR_BLOCKS`, the one table of every kernel's depth).

`lower_bound_windows` is traced as ``lookup.search``
(`repro_torch.obs.trace.span`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bounded_search import kernel
from repro_torch.obs.trace import span

#: ``lookup.cuh``'s ``kNearMax``: a window of at most this many positions
#: is searched near its midpoint first
NEAR_MAX = 4096
#: a sector of the card's memory, the unit the near search walks out in
SECTOR_BYTES = 32
#: each kernel's ``kNearBlocks`` by (kernel, key type): ``bounded_search.cu``
#: walks int64 keys to the edge of the midpoint's sector and searches the
#: int32 slot index balanced alone; ``rmi_lookup.cu`` walks one sector further
NEAR_BLOCKS = {("bounded_search", torch.int64): 0,
               ("bounded_search", torch.int32): -1,
               ("rmi_lookup", torch.int64): 1}


def clip_windows(n: int, lo, max_width: int, hi=None):
    """Each query's window as int64 ``(start, count)``."""
    start = torch.clamp(lo.to(torch.int64), 0, n - 1)
    last = start + (int(max_width) - 1)
    if hi is not None:
        last = torch.minimum(last, hi.to(torch.int64))
    last = torch.clamp(last, max=n)
    return start, torch.clamp(last - start + 1, min=0)


def window_probes(count):
    """``ceil(log2(count + 1))``: the probes a balanced search of a window
    of ``count`` positions makes at most (the bit length of ``count``)."""
    probes = torch.zeros_like(count)
    c = count.clone()
    while bool((c > 0).any()):
        probes += (c > 0).to(probes.dtype)
        c >>= 1
    return probes


def _below(data, queries, p):
    """Whether ``data[p] < q``, position ``n`` comparing as +inf."""
    n = data.shape[0]
    return (p < n) & (data[p.clamp(0, n - 1)] < queries)


def search_windows_plain(data, queries, lo, max_width: int, hi,
                         near_blocks: int, with_probes: bool = False):
    """``lookup.cuh``'s ``window_lower_bound`` as torch ops, step for step:
    for a window of 1 to `NEAR_MAX` positions (``near_blocks >= 0``) the
    midpoint, the edge of its sector on the answer's side, then up to
    ``near_blocks`` sectors 1, 3, 7, ... further out while no probe has
    bracketed the answer; then the balanced search over what is left,
    every query stepping while its own window is non-empty (masked lanes
    hold still).  With ``with_probes`` also each query's probes, the loads
    of ``data`` the kernel's loop makes for it, as int64."""
    n = data.shape[0]
    if n == 0:
        ranks = torch.zeros(queries.shape[0], dtype=torch.int32,
                            device=queries.device)
        return (ranks, ranks.to(torch.int64)) if with_probes else ranks
    a, count = clip_windows(n, lo, max_width, hi)
    b = a + count
    probes = torch.zeros_like(a)
    if near_blocks >= 0:
        unit = SECTOR_BYTES // data.element_size()
        near = (count >= 1) & (count <= NEAR_MAX)
        probes += near
        mid = a + count // 2
        go_r = near & _below(data, queries, mid)
        go_l = near & ~go_r
        a = torch.where(go_r, mid + 1, a)
        b = torch.where(go_l, mid, b)
        p = torch.where(go_r, mid | (unit - 1), mid & ~(unit - 1))
        step = torch.full_like(a, unit)
        for _ in range(near_blocks + 1):
            go_r &= p < b
            go_l &= p >= a
            probed = (go_r & (p > mid)) | (go_l & (p < mid))
            probes += probed
            lt = _below(data, queries, p) & probed
            ge = probed & ~lt
            a = torch.where(lt, p + 1, a)
            b = torch.where(ge, p, b)
            go_r &= ~ge
            go_l &= ~lt & (p >= step)
            p = torch.where(go_r, p + step, torch.where(go_l, p - step, p))
            step = step * 2
    for _ in range(min(max(int(max_width), 0), n + 1).bit_length()):
        active = a < b
        probes += active
        mid = a + (b - a) // 2
        right = active & _below(data, queries, mid)
        a = torch.where(right, mid + 1, a)
        b = torch.where(active & ~right, mid, b)
    return (a.to(torch.int32), probes) if with_probes else a.to(torch.int32)


def lower_bound_windows_plain(data, queries, lo, max_width: int, hi=None):
    """The kernel's search as torch ops (`search_windows_plain` at the
    key type's `NEAR_BLOCKS`)."""
    return search_windows_plain(
        data, queries, lo, max_width, hi,
        NEAR_BLOCKS.get(("bounded_search", data.dtype), -1))


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
    with span("lookup.search"):
        if data.device.type == "cpu":
            return lower_bound_windows_plain(data, queries, lo, max_width,
                                             hi)
        if n == 0:
            return torch.zeros(queries.shape[0], dtype=torch.int32,
                               device=queries.device)
        return kernel.launch(data, queries, lo, max_width, hi)
