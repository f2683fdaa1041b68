"""One run of one cell: make the inputs from the seed, build the port's
index through its public read path, drive it for a fixed number of
seconds with a fixed number of batches in flight, and judge what it
answered against the plain reference.

Set-up (counted in ``setup_s``): the keys and the query pool are made on
the device (`keys`, `traffic`), the keys from the configuration's
``key_seed`` (one fixed draw stands for the one published file, so every
run indexes the same keys), the queries from the run's seed; the raw
keys and queries wait on the host for the reference.  The port builds
its index from a host copy of the keys (``core.spec.build``), lowers it
onto the device keys in the port's codec (``core.plan.lower``) and
compiles it (``LookupPlan.compile("cuda")``); one lap of the pool warms
every shape.

The window: the host submits a batch whenever fewer than ``in_flight``
are queued, waiting on the oldest one's completion event otherwise, for
``seconds``; then it drains.  A reservoir of the window's answers, drawn
from the seed, is copied on the device into a buffer made in set-up.
With tracing, a second, shorter window runs under `torch.profiler` for
the device metrics, each host step in a span of its own.

The device peak is the allocator's over the port's set-up and the
window, less the query pool and the reservoir, which the benchmark holds
there the whole time; the keys in the port's codec, which the port's
plan holds, count.

After the windows the program's state is freed and the reference
(`reference.lower_bound`) works out each sampled batch's ranks again from
the raw keys and queries the benchmark made.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from lookup_bench import codec, devtrace, keys as keygen, load_file
from lookup_bench import reference, roofline, traffic

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
CONFIGS = HERE / "configs"
METRICS = HERE / "metrics"

#: top-level module names that may not be loaded when a run ends
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: sampled batches of answers kept for the reference
RESERVOIR = 16
#: longest traced window, seconds
TRACE_SECONDS = 2.0
#: seed streams
KEYS, QUERIES = 1, 2


def load_benchmark() -> dict:
    with open(BENCHMARK) as f:
        return json.load(f)


def load_config(name: str) -> dict:
    with open(CONFIGS / f"{name}.json") as f:
        config = json.load(f)
    for key in ("dataset", "n_keys", "key_seed", "index"):
        if key not in config:
            raise ValueError(f"configuration {name} has no {key!r}")
    return config


def load_metric(name: str):
    """The reader ``metrics/<name>.py``."""
    return load_file(METRICS / f"{name}.py")


def generator(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return gen


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class _HostMark:
    """A completion mark on the CPU, where every call has finished when
    it returns."""

    def record(self):
        pass

    def synchronize(self):
        pass


class Window:
    """What one timed loop saw."""

    def __init__(self):
        self.latency_s = []     # submission to observed completion
        self.call_s = 0.0       # host time inside the compiled callable
        self.slots = []         # pool slot of each batch
        self.t0 = self.t_end = 0.0

    @property
    def batches(self) -> int:
        return len(self.slots)


def drive(fn, pool, in_flight: int, seconds=None, batches=None,
          keep=None, spans: bool = False) -> Window:
    """Call ``fn`` on the pool's batches in turn, at most ``in_flight``
    queued, until ``seconds`` have passed or ``batches`` were submitted;
    then wait for all.  ``keep(k, slot, out)`` sees every answer."""
    cuda = pool.is_cuda
    span = torch.profiler.record_function if spans \
        else (lambda name: contextlib.nullcontext())
    marks = [torch.cuda.Event() if cuda else _HostMark()
             for _ in range(in_flight)]
    queue = collections.deque()
    w = Window()

    def retire():
        t_sub, mark = queue.popleft()
        mark.synchronize()
        w.latency_s.append(time.perf_counter() - t_sub)

    n_pool = pool.shape[0]
    w.t0 = time.perf_counter()
    deadline = None if seconds is None else w.t0 + seconds
    k = 0
    while True:
        if batches is not None and k >= batches:
            break
        if deadline is not None and time.perf_counter() >= deadline:
            break
        if len(queue) == in_flight:
            with span("wait"):
                retire()
        with span("pool_next"):
            slot = k % n_pool
            q = pool[slot]
        t_sub = time.perf_counter()
        with span("call"):
            out = fn(q)
        w.call_s += time.perf_counter() - t_sub
        mark = marks[k % in_flight]
        mark.record()
        queue.append((t_sub, mark))
        w.slots.append(slot)
        if keep is not None:
            keep(k, slot, out)
        k += 1
    with span("wait"):
        while queue:
            retire()
    w.t_end = time.perf_counter()
    return w


class Reservoir:
    """A uniform sample of at most ``size`` batches of a window's answers,
    drawn from the seed (Algorithm R), each copied as it comes into a row
    of one buffer made beforehand, so the answers themselves are freed as
    they would be without it."""

    def __init__(self, size: int, seed: int, batch: int, device):
        self.size = size
        self.rng = random.Random(seed)
        self.buf = torch.empty((size, batch), dtype=torch.int64,
                               device=device)
        self.kept = []          # (pool slot, answers given) of each row

    def __call__(self, k: int, slot: int, out) -> None:
        if len(self.kept) < self.size:
            j = len(self.kept)
            self.kept.append(None)
        else:
            j = self.rng.randrange(k + 1)
            if j >= self.size:
                return
        flat = out.reshape(-1)
        m = min(flat.shape[0], self.buf.shape[1])
        self.buf[j, :m].copy_(flat[:m])
        self.kept[j] = (slot, flat.shape[0])

    def rows(self):
        """``(slot, answers, given)`` of each kept batch: the answers
        held (at most a batch) and how many the call gave."""
        width = self.buf.shape[1]
        return [(slot, self.buf[j, :min(given, width)], given)
                for j, (slot, given) in enumerate(self.kept)]


def power_limit_w(device):
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, t_process: float, bench: dict = None,
             scale: dict = None, wrap=None, program: bool = True) -> dict:
    """One run of ``workload``; the result line as a dict.

    ``scale`` overrides the configuration's ``n_keys`` and the traffic's
    ``batch`` and ``pool_batches`` (tests run small cells on the CPU);
    ``wrap(fn, inputs)`` replaces the compiled lookup by another callable
    (the control, or a planted fault); without ``program`` the port
    builds nothing and ``wrap`` gets no callable."""
    from repro_torch.core import plan as rplan
    from repro_torch.core import spec as rspec

    bench = bench or load_benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}[workload]
    config = load_config(entry["config"])
    mix = traffic.load(entry["traffic"])
    scale = scale or {}
    n = int(scale.get("n_keys", config["n_keys"]))
    batch = int(scale.get("batch", mix["batch"]))
    pool_batches = int(scale.get("pool_batches", mix["pool_batches"]))
    in_flight = mix["in_flight"]
    device = torch.device(device)
    cuda = device.type == "cuda"
    split = {}

    # -- inputs, made on the device: the configuration's keys, the run's
    # -- queries -----------------------------------------------------------
    t = time.perf_counter()
    raw_keys = keygen.load(config["dataset"]).generate(
        n, generator(config["key_seed"], KEYS, device), device)
    if raw_keys.shape[0] != n or int(raw_keys[0]) < 0 \
            or not bool((raw_keys[1:] > raw_keys[:-1]).all()):
        raise RuntimeError("the dataset generator made no sorted unique "
                           f"keys in [0, 2^63) of length {n}")
    raw_pool = traffic.make_pool(raw_keys, mix,
                                 generator(seed, QUERIES, device), batch,
                                 pool_batches)
    data = codec.encode(raw_keys)
    pool = codec.encode(raw_pool)
    raw_keys, raw_pool = raw_keys.cpu(), raw_pool.cpu()
    sample = Reservoir(RESERVOIR, seed, batch, device)
    _sync(device)
    split["inputs_s"] = time.perf_counter() - t
    gc.collect()
    inputs_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    held = pool.untyped_storage().nbytes() \
        + sample.buf.untyped_storage().nbytes()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # -- the program's set-up ----------------------------------------------
    t = time.perf_counter()
    build = plan = fn = None
    index_bytes = 0
    if program:
        build = rspec.build(rspec.IndexSpec.from_dict(config["index"]),
                            raw_keys.numpy().view(np.uint64),
                            device=device)
        plan = rplan.lower(build, data)
        fn = plan.compile("cuda")
        index_bytes = int(build.size_bytes)
    _sync(device)
    build_s = time.perf_counter() - t
    if wrap is not None:
        fn = wrap(fn, {"raw_keys": raw_keys, "raw_pool": raw_pool,
                       "seed": seed})
    t = time.perf_counter()
    drive(fn, pool, in_flight, batches=pool_batches)
    split["warm_s"] = time.perf_counter() - t
    resident = torch.cuda.memory_allocated(device) - held if cuda else 0

    # -- the window ----------------------------------------------------------
    w = drive(fn, pool, in_flight, seconds=seconds, keep=sample)
    setup_s = w.t0 - t_process
    window_s = w.t_end - w.t0
    peak = torch.cuda.max_memory_allocated(device) - held if cuda else 0

    traced = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if cuda else [])
        _sync(device)
        with profile(activities=activities) as prof:
            with torch.profiler.record_function("window"):
                traced = drive(fn, pool, in_flight,
                               seconds=min(seconds, TRACE_SECONDS),
                               spans=True)
        t = time.perf_counter()
        summary = devtrace.summarize(devtrace.export_events(prof))
        split["trace_read_s"] = time.perf_counter() - t
        del prof
    del fn, plan, build, data, pool
    gc.collect()

    # -- the reference --------------------------------------------------------
    t = time.perf_counter()
    want = reference.lower_bound(raw_keys.to(device), raw_pool.to(device))
    wrong = failed = 0
    for slot, got, given in sample.rows():
        bad = reference.wrong_ranks(got, want[slot]) \
            + max(given - got.shape[0], 0)
        wrong += bad
        failed += bad > 0
    checked = len(sample.kept)
    del sample
    split["reference_s"] = time.perf_counter() - t

    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    values = {
        "lookups_per_s": w.batches * batch / window_s,
        "batch_p95_ms": float(np.percentile(w.latency_s, 95)) * 1e3,
        "device_peak_gib": peak / 2 ** 30,
        "setup_s": setup_s,
    }
    metrics = {}
    if not trace:
        for m in bench["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        slot_bytes = [roofline.batch_bytes(n, want[s])
                      for s in range(pool_batches)]
        ctx = {"build_s": build_s, "index_bytes": index_bytes,
               "call_s": w.call_s, "calls": w.batches, "trace": summary,
               "traced_bytes": sum(slot_bytes[s] for s in traced.slots),
               "kind": kind}
        for m in bench["per_layer"]:
            value = load_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    del want

    result = {
        "correct": wrong == 0 and checked > 0,
        "attempted": w.batches,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1,
                   "memory_peak_bytes": peak},
    }
    if trace:
        result["device"]["busy_s"] = summary.get("busy_s", 0.0)
        result["device"]["window_s"] = summary.get("window_s",
                                                   traced.t_end - traced.t0)
        if summary:
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
    result["info"] = {
        "workload": workload, "seed": seed, "seconds": seconds,
        "window_s": window_s, "batches": w.batches, "batch": batch,
        "n_keys": n, "index_build_s": build_s, "index_bytes": index_bytes,
        "values": values, "setup_split_s": split,
        "inputs_peak_bytes": inputs_peak, "held_bytes": held,
        "resident_bytes": resident,
        "checked_batches": checked,
        "power_limit_w": power_limit_w(device) if cuda else None,
        "traced_batches": traced.batches if traced else None,
        "trace_kernels": summary.get("kernel_count") if trace else None,
    }
    result["checks"] = {
        "wrong_ranks": {"value": wrong, "limit": 0, "is": "at most"},
        "checked_batches": {"value": checked, "limit": 1, "is": "at least"},
    }
    return result
