"""The port's own spans and window counter, read in one cell: what the
benchmark's per-layer metrics of the caller's dispatch, the last mile
and the index's fit would read once the harness installs them.

    python3 lookup_bench/progtrace.py --workload wikits200M-pgm.uniform \
        --seed 7 --seconds 10 --turns 3

Run from the root of a checkout on a machine with a CUDA card; the last
line of standard output is a JSON record.  It makes a cell's inputs and
set-up as `harness.run_cell` does, with a `SpanRecorder` installed
around the port's set-up (``index.fit``, ``index.lower``,
``index.compile`` and their children), then:

- ``turns``: untraced windows of ``--seconds`` in turns, without and with
  a recorder installed (off, on, on, off, ...): the host's time a call
  (``host_call_us``) and ``lookups_per_s`` of each, the cost of the
  port's spans when they record;
- ``program``: a window of at most `harness.TRACE_SECONDS` under
  `torch.profiler`, the harness's traced window, read by `attribute`
  (the port's ``lookup`` spans, the kernels each span launched and the
  device's idle time inside them) beside `devtrace.summarize`;
- ``windows``: the window counter (`LookupPlan.searched_windows`,
  reduced by `core.plan.window_counts`) over every batch of the pool,
  after the profiled window, and the queries whose window holds more
  than ``2^20`` keys.

A port without the spans or the counter (an older checkout) gives a
record without them: nothing raises for their absence.  It checks no
answer: `run.py` does.
"""
from __future__ import annotations

import contextlib
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: the harness's own host spans, and the traced window's
HARNESS_SPANS = {"window", "call", "wait", "pool_next"}
#: the port's span of one call of its compiled lookup
LOOKUP = "lookup"
#: a window wider than this many keys counts as wide
WIDE = 1 << 20
#: the most recent spans searched back for the one open at a launch
DEPTH = 64


def _overlap(a: list, b: list) -> float:
    """Total length of the intersection of two unions of intervals,
    each sorted and disjoint."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def attribute(events: list) -> dict:
    """The port's ``lookup`` spans in the traced ``window`` span of a
    Chrome trace's complete events (`devtrace.export_events`):

    - ``calls``: the ``lookup`` spans that start in the window;
    - ``launches``: device operations (kernels, copies, fills) launched
      inside one of them, each matched to its runtime launch by
      ``args.correlation``;
    - ``by_span``: device seconds in the window by the innermost port
      span open on the launching thread at the launch (``none`` where
      no port span was open);
    - ``dispatch_idle_s``: seconds of the window in which the device ran
      nothing while the host was inside a ``lookup`` span;
    - ``window_s``: the window's length.

    Empty when the trace holds no window span."""
    from lookup_bench import devtrace

    windows = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == "window"]
    if not windows:
        return {}
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
         e.get("tid")) for e in events
        if e.get("cat") == "user_annotation"
        and e["name"] not in HARNESS_SPANS)
    starts = [s[0] for s in spans]
    lookups = [(s, t) for s, t, name, _ in spans
               if name == LOOKUP and w0 <= s < w1]
    launch_at = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_at[corr] = (float(e["ts"]), e.get("tid"))

    def innermost(ts, tid):
        """The latest-started span of ``tid`` still open at ``ts``
        (spans of one thread nest, so it is the innermost)."""
        k = bisect.bisect_right(starts, ts)
        for s, t, name, span_tid in reversed(spans[max(0, k - DEPTH):k]):
            if t >= ts and span_tid == tid:
                return name
        return "none"

    busy, by_span, launches = [], {}, 0
    for e in events:
        if e.get("cat") not in devtrace.DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        busy.append((s, t))
        at = launch_at.get((e.get("args") or {}).get("correlation"))
        name = innermost(*at) if at else "none"
        by_span[name] = by_span.get(name, 0.0) + (t - s) * 1e-6
        if at:
            k = bisect.bisect_right(lookups, (at[0], float("inf")))
            launches += k > 0 and lookups[k - 1][1] >= at[0]
    inside = devtrace._union([(s, min(t, w1)) for s, t in lookups])
    idle = sum(t - s for s, t in inside) - _overlap(
        inside, devtrace._union(busy))
    return {
        "calls": len(lookups),
        "launches": launches,
        "dispatch_idle_s": idle * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
    }


def seconds_by_span(spans) -> dict:
    """Seconds by span name of recorded `Span`s, summed."""
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + s.dur
    return out


def window_pass(plan, pool) -> dict:
    """The window counter over every batch of ``pool`` (summed), and
    the queries whose window holds more than `WIDE` keys; empty where
    the port has no counter."""
    try:
        from repro_torch.core.plan import window_counts
    except ImportError:
        return {}
    if not hasattr(plan, "searched_windows"):
        return {}
    total = {"queries": 0, "width_sum": 0, "steps_sum": 0, "wide": 0}
    for q in pool:
        lo, hi = plan.searched_windows(q)
        for key, value in window_counts(lo, hi).items():
            total[key] += value
        total["wide"] += int((hi - lo + 1 > WIDE).sum())
    return total


def _recording():
    """``recording`` of the port's trace module, or None for a port
    without it."""
    from repro_torch.obs import trace
    return getattr(trace, "recording", None)


def run(workload: str, seed: int, seconds: float, turns: int, device,
        t_process: float, scale: dict = None) -> dict:
    """One cell's record (see the module's docstring); ``scale`` as in
    `harness.run_cell`."""
    import gc

    import numpy as np
    import torch

    from lookup_bench import codec, devtrace, harness
    from lookup_bench import keys as keygen
    from lookup_bench import traffic
    from repro_torch.core import plan as rplan
    from repro_torch.core import spec as rspec
    from repro_torch.obs.trace import SpanRecorder

    bench = harness.load_benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}[workload]
    config = harness.load_config(entry["config"])
    mix = traffic.load(entry["traffic"])
    scale = scale or {}
    n = int(scale.get("n_keys", config["n_keys"]))
    batch = int(scale.get("batch", mix["batch"]))
    pool_batches = int(scale.get("pool_batches", mix["pool_batches"]))
    device = torch.device(device)
    cuda = device.type == "cuda"
    recording = _recording()

    raw_keys = keygen.load(config["dataset"]).generate(
        n, harness.generator(config["key_seed"], harness.KEYS, device),
        device)
    raw_pool = traffic.make_pool(
        raw_keys, mix, harness.generator(seed, harness.QUERIES, device),
        batch, pool_batches)
    data, pool = codec.encode(raw_keys), codec.encode(raw_pool)
    host_keys = raw_keys.cpu().numpy().view(np.uint64)
    del raw_keys, raw_pool
    gc.collect()

    setup = SpanRecorder()
    t = time.perf_counter()
    with recording(setup) if recording else contextlib.nullcontext():
        build = rspec.build(rspec.IndexSpec.from_dict(config["index"]),
                            host_keys, device=device)
        plan = rplan.lower(build, data)
        fn = plan.compile("cuda")
    harness._sync(device)
    build_s = time.perf_counter() - t
    harness.drive(fn, pool, mix["in_flight"], batches=pool_batches)

    record = {"workload": workload, "seed": seed, "seconds": seconds,
              "n_keys": n, "batch": batch, "spans": recording is not None,
              "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
              "power_limit_w": harness.power_limit_w(device) if cuda
              else None,
              "index_build_s": build_s,
              "setup_spans_s": seconds_by_span(setup.spans()),
              "turns": []}
    for k in range(2 * turns):
        on = k % 4 in (1, 2)
        rec = SpanRecorder(capacity=1 << 16)
        with recording(rec) if on and recording \
                else contextlib.nullcontext():
            w = harness.drive(fn, pool, mix["in_flight"], seconds=seconds)
        record["turns"].append({
            "spans_on": on, "batches": w.batches,
            "host_call_us": w.call_s / w.batches * 1e6,
            "lookups_per_s": w.batches * batch / (w.t_end - w.t0),
            "spans_recorded": rec.n_recorded})

    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if cuda else [])
    harness._sync(device)
    with profile(activities=activities) as prof:
        with torch.profiler.record_function("window"):
            traced = harness.drive(fn, pool, mix["in_flight"],
                                   seconds=min(seconds,
                                               harness.TRACE_SECONDS),
                                   spans=True)
    events = devtrace.export_events(prof)
    del prof
    summary = devtrace.summarize(events)
    record["trace"] = {
        "batches": traced.batches,
        "host_call_us": traced.call_s / traced.batches * 1e6,
        "busy_s": summary.get("busy_s"),
        "kernel_count": summary.get("kernel_count"),
        "window_s": summary.get("window_s")}
    record["program"] = attribute(events)
    del events
    record["windows"] = window_pass(plan, pool)
    record["at_s"] = time.perf_counter() - t_process
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    if not torch.cuda.is_available():
        print("progtrace needs a CUDA card", file=sys.stderr)
        return 1
    record = run(args.workload, args.seed, args.seconds, args.turns,
                 torch.device("cuda", 0), T_PROCESS)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
