"""Trace replay: the ground-truth oracle and the service driver.

`oracle_replay` is deliberately naive — a plain sorted numpy array,
`np.searchsorted` for every read, `np.insert` for every admitted insert.
It shares no code with the delta/merge machinery it checks, which is
what makes it an oracle: the mutable-index invariant
is "every op's result equals this replay's, at every step, across any
number of compactions".

`replay_on_service` drives a `MutableLookupService` through the same
trace, preserving admission order (the order the oracle models), and
returns the per-op results aligned with the oracle's output.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.workloads.workload import OP_INSERT, OP_RANGE, Workload

__all__ = ["oracle_replay", "oracle_scan_replay", "replay_on_service"]

_UINT64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def oracle_replay(base_keys: np.ndarray, wl: Workload) -> np.ndarray:
    """Per-op ground truth: LB position for reads/ranges, 0/1 admitted
    flag for inserts (set semantics — a present key is not re-inserted)."""
    out, _ = oracle_scan_replay(base_keys, wl, scan_windows=False)
    return out


def oracle_scan_replay(base_keys: np.ndarray, wl: Workload,
                       scan_windows: bool = True,
                       ) -> Tuple[np.ndarray, Dict[int, np.ndarray]]:
    """`oracle_replay` plus, for every OP_RANGE op, the materialized
    window: the ``aux[i]`` keys from the op's LB position over the array
    AS OF that step, padded past the end with UINT64_MAX — the same
    sentinel the plan's windowed gather uses, so service scans compare
    bit-for-bit.  Returns (per-op results, {op index: window})."""
    arr = np.asarray(base_keys, dtype=np.uint64).copy()
    out = np.empty(wl.n_ops, dtype=np.int64)
    windows: Dict[int, np.ndarray] = {}
    for i in range(wl.n_ops):
        k = wl.keys[i]
        if wl.ops[i] == OP_INSERT:
            p = int(np.searchsorted(arr, k, side="left"))
            if p < len(arr) and arr[p] == k:
                out[i] = 0
            else:
                arr = np.insert(arr, p, k)
                out[i] = 1
        else:
            p = int(np.searchsorted(arr, k, side="left"))
            out[i] = p
            if scan_windows and wl.ops[i] == OP_RANGE:
                m = int(wl.aux[i])
                w = np.full(m, _UINT64_MAX, dtype=np.uint64)
                seg = arr[p:p + m]
                w[:seg.size] = seg
                windows[i] = w
    return out, windows


def replay_on_service(wl: Workload, svc, chunk: int = 64,
                      timeout: Optional[float] = 60.0,
                      compact_every: Optional[int] = None,
                      scan_ranges: bool = False):
    """Drive a lookup service through ``wl``; returns per-op results
    aligned with `oracle_replay` (positions for reads/ranges, admitted
    flags for inserts).

    Consecutive same-op runs are submitted as one request (up to
    ``chunk`` ops) — admission order equals trace order, which the
    single-flusher FIFO then turns into apply order, so the results are
    comparable to the oracle with no reordering bookkeeping.  When the
    service has no background flusher, the queue is drained in-line.
    ``compact_every`` forces a synchronous compaction every that many
    ops (on top of the service's own threshold trigger) — the invariant
    says results must not change, so replays use it to pin hot-swap
    correctness mid-trace.

    With ``scan_ranges=True``, OP_RANGE ops execute END-TO-END as op
    kind "scan" (`svc.scan`): each range materializes its ``aux``-length
    record window through the plan's windowed gather, and the return
    value becomes ``(out, windows)`` with ``windows[i]`` comparable
    bit-for-bit to `oracle_scan_replay`'s.  Runs are split on the op
    kind AND scan length (a compile-shape axis).
    """
    futs = []      # (start, end, op, future)
    i = 0
    next_compact = compact_every
    while i < wl.n_ops:
        j = i
        op = wl.ops[i]
        while (j < wl.n_ops and wl.ops[j] == op and j - i < chunk
               and wl.aux[j] == wl.aux[i]):
            j += 1
        ks = wl.keys[i:j]
        if op == OP_INSERT:
            fut = svc.insert(ks)
        elif op == OP_RANGE and scan_ranges:
            fut = svc.scan(ks, int(wl.aux[i]))
        else:
            fut = svc.submit(ks)
        futs.append((i, j, op, fut))
        if svc._thread is None:
            svc.drain()
        if next_compact is not None and j >= next_compact:
            svc.force_compact()
            next_compact += compact_every
        i = j
    if svc._thread is None:
        svc.drain()
    out = np.empty(wl.n_ops, dtype=np.int64)
    windows: Dict[int, np.ndarray] = {}
    for start, end, op, fut in futs:
        res = fut.result(timeout)
        if op == OP_RANGE and scan_ranges:
            pos, win = res
            out[start:end] = pos
            for k in range(start, end):
                windows[k] = win[k - start]
        else:
            out[start:end] = res
    if scan_ranges:
        return out, windows
    return out
