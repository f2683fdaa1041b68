"""Reading a traced window: the profiler's timeline reduced to device
busy time, kernel time by name, and the idle gaps named by the span the
host was in.

The traced loop wraps the whole window in a ``window`` span and each step
of the host in ``call``, ``wait`` or ``pool_next``
(`torch.profiler.record_function`); the exported Chrome trace puts those
spans and the device's kernels, copies and fills on one clock.
"""
from __future__ import annotations

import json
import os
import tempfile

#: Chrome-trace categories of work that occupies the device
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_SPANS = ("call", "wait", "pool_next")


def export_events(prof) -> list:
    """The complete events of a finished `torch.profiler.profile`."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals):
    """Merged, sorted ``[start, end]`` intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events: list, top: int = 10) -> dict:
    """Busy and kernel seconds inside the ``window`` span, its length, the
    device operations that took most time, and the longest idle gaps by
    the host span each began in.  Empty when the trace holds no window
    span or no device work."""
    windows = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == "window"]
    if not windows:
        return {}
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    device, kernels, by_name = [], [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        device.append((s, t))
        if e["cat"] == "kernel":
            kernels.append((s, t))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (t - s)
    if not device:
        return {}
    busy = _union(device)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") in HOST_SPANS)
    gaps, cursor = [], w0
    for s, t in busy + [[w1, w1]]:
        if s > cursor:
            gaps.append((s - cursor, cursor))
        cursor = max(cursor, t)
    named = []
    for length, start in sorted(gaps, reverse=True)[:top]:
        name = "outside"
        for s, t, span in spans:
            if s > start:
                break
            if t > start:
                name = span
        named.append([name, length * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(t - s for s, t in busy) * 1e-6,
        "kernel_s": sum(t - s for s, t in _union(kernels)) * 1e-6,
        "kernel_count": len(kernels),
        "device_ops": [[name, us * 1e-6] for name, us in ops],
        "idle_gaps": named,
    }
