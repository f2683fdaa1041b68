#!/usr/bin/env python3
"""Drive the PyTorch port's learned-index read path on one NVIDIA card.

    python3 chip_smoke.py [--n 200000000] [--seed 0] [--out PATH]

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain torch version bit for bit,
then runs the main path at full size on two surrogates: ``amzn``, on which
12% of the RMI's windows span much of the array, and ``wiki``, whose
windows are narrow.  Each gets an RMI with 2^18 stage-2 models built
through ``spec.build`` and a ``LookupPlan`` compiled for the ``cuda``
backend (fused: one ``rmi_lookup`` launch a batch; unfused: the torch
predict, then ``bounded_search``) and the ``torch`` backend; 10M queries in
batches of 1M, every answer held against ``np.searchsorted`` on the host.

Per cell, after the main path: the device's idle share over the fused
path's 10 batches, and on amzn a ``torch.profiler`` window over them
(device time by kernel, idle share); the kernels' device times at the main
path's shapes beside their plain versions, bounds and
``torch.searchsorted``, with the last mile timed in turns against its
earlier design (every query searching the batch's widest window); and the
spread of the windows.  Then every other index family on the same keys and
queries (``families``): PGM, RadixSpline, RBS, BTree, binary search and
the Robin Hood hash, each built through ``spec.build`` at its schema
defaults, run on both backends (the ``cuda`` backend of every family but
the hash is ``bounded_search`` over the family's own windows) against
``np.searchsorted`` or, for the hash, the point oracle, with its launch
counts, B1's time and probes on its windows, and freed before the next.
On amzn the plan transforms of the PGM plan (``transforms``: scan, merged
and merged scan over a delta of 1M absent keys, instrumented with pad
lanes), and per cell B1 over the binary-search plan's whole-array windows
beside ``torch.searchsorted`` (a ``timings`` row).  One JSON line per
phase; any failure exits nonzero.  The last line is the device summary
``{"ok": true, "device": {...}}``.  Full results go to ``--out``.

Imports nothing of JAX and nothing of the reference package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
LANE_OPS_PER_S = 67e12         # H100 SXM 32-bit rate outside the tensor cores
CHECK_N = 1_000_000            # keys and queries of the kernel-vs-plain phase
QUERIES = 10_000_000           # queries of each main-path run
BATCH = 1_000_000              # queries per lookup call
BRANCHING = 2 ** 18            # RMI stage-2 models, the top rung of its ladder
# main-path cells: amzn first (its numbers make the `kernels` line), then a
# surrogate on which the RMI's windows are narrow
MAIN_DATASETS = ("amzn", "wiki")
KERNEL_SOURCES = {
    "bounded_search": ("src/repro_torch/csrc/bounded_search.cu",
                       "src/repro/kernels/bounded_search/kernel.py:61"),
    "rmi_lookup": ("src/repro_torch/csrc/rmi_lookup.cu",
                   "src/repro/kernels/rmi_lookup/kernel.py:49"),
}
# the last mile's designs: the earlier (every query searches the batch's
# widest window, the kernel given no hi) and the kept one (its own window)
B1_DESIGNS = ("batch_width", "per_query")
B1_KEPT = "per_query"
# every other index family, at its schema defaults (robin_hash is point-only;
# ibtree shares btree's state and cuda path, so it is not built again)
FAMILIES = (("pgm", {"eps": 64}), ("radix_spline", {"eps": 32,
                                                     "radix_bits": 16}),
            ("rbs", {"radix_bits": 16}), ("btree", {"sample": 1,
                                                    "fanout": 128}),
            ("binary_search", {}), ("robin_hash", {"load_factor": 0.5}))
TRANSFORMS_CELL = "amzn"       # the plan transforms run over its PGM plan
SCAN_M = 16                    # records a scan materializes
DELTA_KEYS = 1_000_000         # absent keys of the merged lookups' delta
N_VALID = BATCH - 12_345       # lanes the instrumented lookup counts


class SmokeFailure(RuntimeError):
    pass


def emit(record: dict, log: list) -> None:
    log.append(record)
    print(json.dumps(record), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / LANE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def diff(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def phase_build(log):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    info = _build.build_all()
    wall = time.perf_counter() - t0
    for name, rec in sorted(info.items()):
        ptxas = [ln.strip() for ln in rec["ptxas"].splitlines()
                 if "Used" in ln or "spill" in ln or "Compiling" in ln]
        emit({"phase": "build", "kernel": name, "nvcc_s": rec["seconds"],
              "cached": rec["cached"], "ptxas": ptxas}, log)
    check(set(KERNEL_SOURCES) <= set(info),
          f"kernels built: {sorted(info)}")
    return wall


def phase_kernels_vs_plain(dev, seed, log, errs):
    """Every kernel entry against its plain version on every surrogate."""
    import numpy as np
    import torch
    from repro_torch.data import sosd
    from repro_torch.kernels.bounded_search import ops as bops
    from repro_torch.kernels.common import encode_keys
    from repro_torch.kernels.rmi_lookup import ops as rops

    n = m = CHECK_N
    for ds in sosd.DATASETS:
        keys = sosd.generate(ds, n, seed=seed)
        q = sosd.make_queries(keys, m, seed=seed)
        lb = torch.from_numpy(np.searchsorted(keys, q)).to(dev)
        data, qt = encode_keys(keys, dev), encode_keys(q, dev)
        for branching in (512, 2 ** 18):
            st = rops.prepare_f32_state(keys, branching=branching, device=dev)
            lo, hi = rops.rmi_bounds(st, qt)
            plo, phi = rops.rmi_bounds_plain(st, qt)
            pos = bops.lower_bound_windows(data, qt, lo, st.max_err)
            ppos = bops.lower_bound_windows_plain(data, qt, lo, st.max_err)
            pos_hi = bops.lower_bound_windows(data, qt, lo, st.max_err, hi)
            ppos_hi = bops.lower_bound_windows_plain(data, qt, lo,
                                                     st.max_err, hi)
            rank = rops.rmi_lookup(st, data, qt)
            prank = rops.rmi_lookup_plain(st, data, qt)
            torch.cuda.synchronize()
            e_bounds = max(diff(lo, plo), diff(hi, phi))
            e_b1 = max(diff(pos, ppos), diff(pos_hi, ppos_hi))
            e_fused = diff(rank, prank)
            errs["rmi_bounds"] = max(errs["rmi_bounds"], e_bounds)
            errs["bounded_search"] = max(errs["bounded_search"], e_b1)
            errs["rmi_lookup"] = max(errs["rmi_lookup"], e_fused)
            valid = bool(((lo <= lb) & (lb <= hi)).all())
            exact = all(bool((x.long() == lb).all())
                        for x in (pos, pos_hi, rank))
            emit({"phase": "kernels_vs_plain", "dataset": ds, "n": n, "m": m,
                  "branching": branching, "max_err": st.max_err,
                  "rmi_bounds_max_abs_err": e_bounds,
                  "bounded_search_max_abs_err": e_b1,
                  "rmi_lookup_max_abs_err": e_fused,
                  "bounds_valid": valid, "lb_exact": exact}, log)
            check(e_bounds == 0 and e_b1 == 0 and e_fused == 0 and valid
                  and exact, f"kernel vs plain on {ds}/{branching}")

    # the TPU kernel's two special cases (a window wider than its 2048-key
    # tile; every query in one tile), then windows that need not hold LB:
    # empty, hi < lo, hi >= n, lo > n-1, placed at random
    rng = np.random.default_rng(seed)
    keys = sosd.generate("amzn", n, seed=seed)
    data = encode_keys(keys, dev)
    cases = {}
    width = 5_000
    q = keys[rng.integers(0, n, m)]
    lb = np.searchsorted(keys, q)
    cases["wide_window"] = (q, np.maximum(lb - rng.integers(0, width - 1, m),
                                          0), None, width)
    q = keys[rng.integers(0, 2_048, m)]
    lb = np.searchsorted(keys, q)
    cases["one_tile"] = (q, np.maximum(lb - 10, 0), None, 64)
    q = np.concatenate([keys[rng.integers(0, n, m // 2)],
                        rng.integers(0, 2**64 - 1, m - m // 2,
                                     dtype=np.uint64)])
    lo = rng.integers(-5, n + 5, m)
    cases["windows_anywhere"] = (q, lo, lo + rng.integers(-3, 303, m), 300)
    for case, (q, lo, hi, width) in cases.items():
        qt = encode_keys(q, dev)
        lo_t = torch.from_numpy(lo).to(dev)
        hi_t = None if hi is None else \
            torch.from_numpy(hi.astype(np.int32)).to(dev)
        pos = bops.lower_bound_windows(data, qt, lo_t, width, hi_t)
        ppos = bops.lower_bound_windows_plain(data, qt, lo_t, width, hi_t)
        e1 = diff(pos, ppos)
        errs["bounded_search"] = max(errs["bounded_search"], e1)
        got = pos.cpu().numpy()
        if hi is None:
            exact = bool((got == np.searchsorted(keys, q)).all())
        else:   # lo plus the count of keys below q inside the window
            start = np.clip(lo, 0, n - 1)
            last = np.minimum(np.minimum(hi, start + width - 1), n)
            real = np.clip(np.minimum(last, n - 1) - start + 1, 0, None)
            exact = bool((got == start + np.clip(
                np.searchsorted(keys, q) - start, 0, real)).all())
        emit({"phase": "kernels_vs_plain", "case": case, "n": n, "m": m,
              "max_width": width, "per_query_hi": hi is not None,
              "bounded_search_max_abs_err": e1, "lb_exact": exact}, log)
        check(e1 == 0 and exact, f"bounded_search vs plain on {case}")


def make_cell(dev, dataset, args):
    """The cell's keys (host), its 10M queries (on the card) and their
    np.searchsorted ranks (host)."""
    import numpy as np
    from repro_torch.data import sosd
    from repro_torch.kernels.common import encode_keys

    t0 = time.perf_counter()
    keys = sosd.generate(dataset, args.n, seed=args.seed)
    t_gen = time.perf_counter() - t0
    queries = sosd.make_queries(keys, QUERIES, seed=args.seed)
    t0 = time.perf_counter()
    lb = np.searchsorted(keys, queries)
    t_oracle = time.perf_counter() - t0
    return {"keys": keys, "queries": queries, "qt": encode_keys(queries, dev),
            "lb": lb, "generate_s": t_gen, "host_oracle_s": t_oracle}


def kernel_counters():
    from repro_torch.kernels.bounded_search import kernel as bs_kernel
    from repro_torch.kernels.rmi_lookup import kernel as rmi_kernel
    return {"rmi_lookup": rmi_kernel.launch_lookup,
            "rmi_bounds": rmi_kernel.launch_bounds,
            "bounded_search": bs_kernel.launch}


def driven(fn):
    """Run ``fn`` with every launch count set to 0 just before it; return
    its result and the counts read just after."""
    import torch
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


def run_batches(fn, qt):
    """A warm-up batch, then the 10 timed ones; ``(ranks, seconds)``."""
    import torch
    fn(qt[:BATCH])                                # warm-up batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [fn(qt[i:i + BATCH]) for i in range(0, QUERIES, BATCH)]
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def phase_main_path(dev, dataset, cell, args, log, totals):
    """The port's RMI read path at full size, through its public entry
    points.  Each run's launch counts are zeroed just before it and read
    just after."""
    import torch
    from repro_torch.core import plan, spec
    from repro_torch.kernels.common import encode_keys

    keys, qt, lb = cell["keys"], cell["qt"], cell["lb"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    build = spec.build(spec.IndexSpec("rmi", {"branching": BRANCHING}), keys,
                       device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    p = plan.lower(build, encode_keys(keys, dev))
    emit({"phase": "main_path_setup", "dataset": dataset, "n": args.n,
          "queries": QUERIES, "batch": BATCH, "branching": BRANCHING,
          "max_err": p.bounds.max_err, "size_bytes": build.size_bytes,
          "generate_s": cell["generate_s"], "build_s": t_build,
          "host_oracle_s": cell["host_oracle_s"]}, log)

    runs = [("cuda", True), ("cuda", False), ("torch", None), ("cuda", True)]
    calls = QUERIES // BATCH + 1                  # a warm-up batch, then 10
    e2e, per_run = {}, []
    launches = {k: 0 for k in kernel_counters()}
    for backend, fused in runs:
        t0 = time.perf_counter()
        fn = p.compile(backend, fused=fused)
        torch.cuda.synchronize()
        t_compile = time.perf_counter() - t0
        (outs, dt), launched = driven(lambda: run_batches(fn, qt))
        got = torch.cat(outs).cpu().numpy()
        exact = bool(got.shape == lb.shape and (got == lb).all())
        label = backend if fused is None else \
            f"{backend}_{'fused' if fused else 'unfused'}"
        rec = {"phase": "main_path", "dataset": dataset, "backend": label,
               "last_mile": p.last_mile if backend == "torch" else "kernel",
               "compile_s": t_compile, "seconds": dt,
               "ns_per_lookup": dt / QUERIES * 1e9,
               "lookups_per_s": QUERIES / dt, "exact": exact,
               "launches": launched}
        e2e.setdefault(label, rec)
        per_run.append({"backend": label, **launched})
        emit(rec, log)
        check(exact, f"main path {dataset}/{label} != np.searchsorted")
        want = {"cuda_fused": {"rmi_lookup": calls},
                "cuda_unfused": {"bounded_search": calls}}.get(label, {})
        check(launched == {k: want.get(k, 0) for k in launched},
              f"{dataset}/{label} launched {launched}")
        for k, v in launched.items():
            launches[k] += v
            totals[k] += v
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "main_path_launches", "dataset": dataset, **launches,
          "calls_per_run": calls, "per_run": per_run,
          "fused_kernel_launches_per_batch":
              per_run[0]["rmi_lookup"] / calls,
          "peak_device_bytes": peak}, log)
    for name in ("rmi_lookup", "bounded_search"):
        check(launches[name] > 0,
              f"{name} was not launched on the {dataset} main path")
    return p, e2e


def phase_profile(p, qt, dataset, log, trace: bool):
    """The fused path's 10 batches on the host clock against 10 times the
    fused kernel's CUDA-event time, which gives the device's idle share;
    with ``trace``, also a torch.profiler window over the same 10 batches:
    device time by kernel, device events a batch, and the idle share it
    shows.  Only the first cell asks for the trace: on an H100 the first
    profiler session of a process recorded all 10 kernels, a second one
    3 of its 10, and one after a traced warm-up cycle none."""
    import torch
    fn = p.compile("cuda")
    batches = QUERIES // BATCH

    def window():
        t0 = time.perf_counter()
        for i in range(0, QUERIES, BATCH):
            fn(qt[i:i + BATCH])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    window()
    plain_wall_us = window()
    kernel_us = cuda_ms(lambda: fn(qt[:BATCH])) * 1e3
    rec = {"phase": "profile", "dataset": dataset, "backend": "cuda_fused",
           "batches": batches, "unprofiled_wall_us": plain_wall_us,
           "kernel_us_per_batch_events": kernel_us,
           "idle_share_unprofiled": 1 - batches * kernel_us / plain_wall_us}
    if not trace:
        emit(rec, log)
        return rec
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_us = window()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in device:
        d = by_name.setdefault(e.name, {"count": 0, "total_us": 0.0})
        d["count"] += 1
        d["total_us"] += e.time_range.elapsed_us()
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:                           # union of busy intervals
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    rec.update({
        "profiled_wall_us": wall_us, "device_events": len(device),
        "device_events_per_batch": len(device) / batches,
        "by_kernel": by_name, "device_busy_us": busy,
        "device_span_us": span,
        "idle_share_of_wall": (1 - busy / wall_us) if device else None,
        "idle_share_of_span": (1 - busy / span) if span else None})
    if not device:
        rec["note"] = "the profiler showed no device time"
    emit(rec, log)
    return rec


def window_spread(count, probes, max_err: int, n: int) -> dict:
    """Spread of one batch's clipped window widths, and the probes the
    last mile makes: a query on average, and a warp of 32 (its slowest
    lane) with the queries in batch order and, to show what regrouping
    could save, sorted by trip class inside each block of 256 (trip counts
    31 and 32 share a class)."""
    import torch
    ws = torch.sort(count).values
    m = ws.numel()
    k = m // 256 * 256
    cls = probes[:k].clamp(max=31).view(-1, 256)
    order = torch.sort(cls, dim=1, stable=True).indices
    regrouped = torch.gather(probes[:k].view(-1, 256), 1, order)
    return {
        **{f"p{int(f * 100)}": int(ws[min(int(f * m), m - 1)])
           for f in (0.5, 0.9, 0.99)},
        "max": int(ws[-1]), "max_err": max_err,
        "share_above_2048": float((count > 2048).double().mean()),
        "share_above_max_err_over_8": float(
            (count > max_err // 8).double().mean()),
        "probes_batch_width": min(max_err, n + 1).bit_length(),
        "mean_probes_per_query": float(probes.double().mean()),
        "mean_probes_per_warp": float(
            probes[:k].view(-1, 32).max(dim=1).values.double().mean()),
        "mean_probes_per_warp_regrouped": float(
            regrouped.reshape(-1, 32).max(dim=1).values.double().mean()),
    }


def probes_of(n, lo, hi, width):
    """What B1's inputs need: each query's window and its own probes,
    every probe after the first two a 32-byte sector; ``(count, probes,
    total probes, sector bytes)``."""
    from repro_torch.kernels.bounded_search import ops as bops
    _, count = bops.clip_windows(n, lo, width, hi)
    probes = bops.window_probes(count)
    return (count, probes, float(probes.sum()),
            float((probes - 2).clamp(min=0).sum()) * 32)


def phase_timings(p, qt, dataset, errs, log):
    """Per-kernel device time at the main path's shapes, beside the plain
    version, the one-call library yardstick, and the bound.  B1 gets what
    the unfused path gives it (the f64 RMI's int64 ``(lo, hi)`` and the
    plan's ``max_err``) and is timed in turns against its earlier design,
    the same kernel given no hi; B2 and the fused kernel get the fused
    path's f32 state."""
    import torch
    from repro_torch.kernels.bounded_search import kernel as bs_kernel
    from repro_torch.kernels.bounded_search import ops as bops
    from repro_torch.kernels.common import lb_steps
    from repro_torch.kernels.rmi_lookup import kernel as rmi_kernel
    from repro_torch.kernels.rmi_lookup import ops as rops

    data, n = p.data, p.data.shape[0]
    q0 = qt[:BATCH].contiguous()
    m = q0.shape[0]
    lo, hi = p.bounds.predict(p.bounds.state, q0)
    W = p.bounds.max_err
    st = p._cache["_rmi_f32_state"]
    fns = {"batch_width": lambda: bs_kernel.launch(data, q0, lo, W),
           "per_query": lambda: bs_kernel.launch(data, q0, lo, W, hi),
           "rmi_bounds": lambda: rmi_kernel.launch_bounds(st, q0),
           "rmi_lookup": lambda: rmi_kernel.launch_lookup(st, data, q0)}
    outs = {k: fns[k]() for k in B1_DESIGNS}
    plain = bops.lower_bound_windows_plain(data, q0, lo, W, hi)
    lo32, hi32 = fns["rmi_bounds"]()
    plo, phi = rops.rmi_bounds_plain(st, q0)
    rank = fns["rmi_lookup"]()
    prank = rops.rmi_lookup_plain(st, data, q0)
    torch.cuda.synchronize()
    for k, out in outs.items():
        check(torch.equal(out, plain),
              f"bounded_search ({k}) vs plain at {dataset} main-path shapes")
    check(torch.equal(lo32, plo) and torch.equal(hi32, phi),
          f"rmi_bounds vs plain at {dataset} main-path shapes")
    check(torch.equal(rank, prank),
          f"rmi_lookup vs plain at {dataset} main-path shapes")
    errs["bounded_search"] = max(errs["bounded_search"],
                                 diff(outs[B1_KEPT], plain))
    errs["rmi_lookup"] = max(errs["rmi_lookup"], diff(rank, prank))
    errs["rmi_bounds"] = max(errs["rmi_bounds"], diff(lo32, plo),
                             diff(hi32, phi))

    count, probes, n_probes, sectors = probes_of(n, lo, hi, W)
    count32, probes32, n_probes32, sectors32 = probes_of(n, lo32, hi32,
                                                         st.max_err)
    steps = lb_steps(W)           # the batch-width design's formula
    io = lo.element_size() + 8 + 4                 # q and lo in, rank out
    tables = st.branching * 12                      # a2, b2, err
    bounds = {
        "batch_width": bound(m * io + m * max(steps - 2, 0) * 32,
                             m * steps * 6),
        "per_query": bound(m * (io + hi.element_size()) + sectors,
                           n_probes * 6),
        "rmi_bounds": bound(m * (8 + 8) + tables, m * 12),
        "rmi_lookup": bound(m * (8 + 8) + tables + sectors32,
                            m * 12 + n_probes32 * 6),
    }

    # in turns: a, b, bounds, fused, fused, bounds, b, a
    order = [*B1_DESIGNS, "rmi_bounds", "rmi_lookup"]
    times = {k: [] for k in order}
    for k in [*order, *reversed(order)]:
        times[k].append(cuda_ms(fns[k]))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    library_ms = cuda_ms(lambda: torch.searchsorted(data, q0))

    kernels = [{
        "name": "bounded_search", "route": "cuda",
        "source": KERNEL_SOURCES["bounded_search"][0],
        "replaces": KERNEL_SOURCES["bounded_search"][1],
        "launches": None,           # the whole script's count, set by main
        "max_abs_err": errs["bounded_search"],
        "ms": ms[B1_KEPT],
        "plain_ms": cuda_ms(lambda: bops.lower_bound_windows_plain(
            data, q0, lo, W, hi)),
        "bound_ms": bounds[B1_KEPT][0], "bound_by": bounds[B1_KEPT][1],
        "library_ms": library_ms, "design": B1_KEPT,
        "designs_ms": {k: ms[k] for k in B1_DESIGNS},
        "designs_bound_ms": {k: bounds[k][0] for k in B1_DESIGNS},
    }, {
        "name": "rmi_lookup", "route": "cuda",
        "source": KERNEL_SOURCES["rmi_lookup"][0],
        "replaces": KERNEL_SOURCES["rmi_lookup"][1],
        "launches": None,
        "max_abs_err": max(errs["rmi_lookup"], errs["rmi_bounds"]),
        "ms": ms["rmi_lookup"],
        "plain_ms": cuda_ms(lambda: rops.rmi_lookup_plain(st, data, q0)),
        "bound_ms": bounds["rmi_lookup"][0],
        "bound_by": bounds["rmi_lookup"][1],
        "library_ms": library_ms,
        "rmi_bounds_ms": ms["rmi_bounds"],
        "rmi_bounds_plain_ms": cuda_ms(lambda: rops.rmi_bounds_plain(st,
                                                                     q0)),
        "rmi_bounds_bound_ms": bounds["rmi_bounds"][0],
    }]
    emit({"phase": "timings", "dataset": dataset, "batch": m,
          "branching": st.branching, "max_err_unfused": W,
          "max_err_fused": st.max_err, "readings_ms": times,
          "probes_unfused": n_probes, "probes_fused": n_probes32,
          "window_unfused": window_spread(count, probes, W, n),
          "window_fused": window_spread(count32, probes32, st.max_err, n),
          "kernels": {k["name"]: {f: v for f, v in k.items()
                                  if f not in ("route", "source",
                                               "replaces", "launches")}
                      for k in kernels}}, log)
    return kernels


def b1_on_windows(p, q0):
    """B1 over one batch's own windows from the plan's predict: its
    device time, its plain version's, the bound and the probes."""
    import torch
    from repro_torch.kernels.bounded_search import kernel as bs_kernel
    from repro_torch.kernels.bounded_search import ops as bops

    data, n, m = p.data, p.data.shape[0], q0.shape[0]
    W = p.bounds.max_err
    lo, hi = p.bounds.predict(p.bounds.state, q0)
    count, probes, n_probes, sectors = probes_of(n, lo, hi, W)
    b, by = bound(m * (8 + lo.element_size() + hi.element_size() + 4)
                  + sectors, n_probes * 6)
    got = bs_kernel.launch(data, q0, lo, W, hi)
    plain = bops.lower_bound_windows_plain(data, q0, lo, W, hi)
    torch.cuda.synchronize()
    check(torch.equal(got, plain), f"bounded_search vs plain on {p.name}")
    return {"b1_ms": cuda_ms(lambda: bs_kernel.launch(data, q0, lo, W, hi)),
            "b1_plain_ms": cuda_ms(lambda: bops.lower_bound_windows_plain(
                data, q0, lo, W, hi), reps=3, warmup=1),
            "b1_bound_ms": b, "b1_bound_by": by,
            "b1_max_abs_err": diff(got, plain),
            "window": window_spread(count, probes, W, n)}


def phase_families(dev, dataset, cell, data, args, log, totals, errs):
    """Every other index family on the cell's keys, built through
    ``spec.build`` on the card at its schema defaults, lowered, and run on
    both backends over the 10M queries; each family is freed before the
    next is built."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core import plan, spec

    keys, qt, lb = cell["keys"], cell["qt"], cell["lb"]
    n = len(keys)
    calls = QUERIES // BATCH + 1
    present = keys[np.minimum(lb, n - 1)] == cell["queries"]
    point = np.where(present, lb, -1)            # the hash's oracle
    q0 = qt[:BATCH].contiguous()
    out = {}
    for name, hyper in FAMILIES:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        build = spec.build(spec.IndexSpec(name, hyper), keys, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        p = plan.lower(build, data)
        rec = {"phase": "families", "dataset": dataset, "index": name,
               "hyper": build.hyper, "build_s": t_build,
               "size_bytes": build.size_bytes, "max_err": p.bounds.max_err,
               "point_only": p.point_only}
        for backend in ("cuda", "torch"):
            fn = p.compile(backend)
            (outs, dt), launched = driven(lambda: run_batches(fn, qt))
            got = torch.cat(outs).cpu().numpy()
            exact = bool((got == (point if p.point_only else lb)).all())
            want = {"bounded_search": calls} \
                if backend == "cuda" and not p.point_only else {}
            rec[backend] = {"ns_per_lookup": dt / QUERIES * 1e9,
                            "seconds": dt, "exact": exact,
                            "launches": launched}
            check(exact, f"{dataset}/{name}/{backend} != the oracle")
            check(launched == {k: want.get(k, 0) for k in launched},
                  f"{dataset}/{name}/{backend} launched {launched}")
            for k, v in launched.items():
                totals[k] += v
        if not p.point_only:
            rec.update(b1_on_windows(p, q0))
            errs["bounded_search"] = max(errs["bounded_search"],
                                         rec["b1_max_abs_err"])
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        emit(rec, log)
        out[name] = rec
        if name == "pgm" and dataset == TRANSFORMS_CELL:
            phase_transforms(p, cell, log, totals)
        if name == "binary_search":
            out["whole_array"] = phase_whole_array(p, q0, dataset, log)
        del build, p, fn
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_transforms(p, cell, log, totals):
    """The plan transforms over one 1M batch of the PGM plan, each on the
    cuda backend: scan, merged and merged scan against a delta of 1M
    absent keys, and the instrumented lookup with pad lanes."""
    import numpy as np
    import torch
    from repro_torch.core import plan
    from repro_torch.kernels.common import decode_keys, encode_keys

    keys, n = cell["keys"], len(cell["keys"])
    q0 = cell["qt"][:BATCH].contiguous()
    q0_np, lb0 = cell["queries"][:BATCH], cell["lb"][:BATCH]
    rng = np.random.default_rng(SCAN_M)
    cand = np.unique(rng.integers(int(keys[0]), int(keys[-1]),
                                  DELTA_KEYS + DELTA_KEYS // 4,
                                  dtype=np.uint64))
    hit = keys[np.minimum(np.searchsorted(keys, cand), n - 1)] == cand
    cand = cand[~hit]
    delta = np.sort(cand[rng.choice(len(cand), DELTA_KEYS, replace=False)])
    pad = 1 << (DELTA_KEYS - 1).bit_length()
    padded = np.full(pad, np.iinfo(np.uint64).max, np.uint64)
    padded[:DELTA_KEYS] = delta
    dt = encode_keys(padded, q0.device)
    union = np.insert(keys, np.searchsorted(keys, delta), delta)
    sentinel = np.iinfo(np.uint64).max

    def windows(arr, start):
        idx = start[:, None] + np.arange(SCAN_M)[None, :]
        return np.where(idx < len(arr), arr[np.minimum(idx, len(arr) - 1)],
                        sentinel)

    runs = {
        "scan": lambda: p.compile_scan(SCAN_M, "cuda")(q0),
        "merged": lambda: p.compile_merged("cuda")(q0, dt),
        "merged_scan": lambda: p.compile_merged_scan(SCAN_M, "cuda")(q0, dt),
        "instrumented": lambda: p.compile_instrumented("cuda")(q0, N_VALID),
    }
    merged_lb = np.searchsorted(union, q0_np)
    lo, hi = p.bounds.predict(p.bounds.state, q0)
    for kind, fn in runs.items():
        res, launched = driven(fn)
        t0 = time.perf_counter()
        if kind == "scan":
            pos, win = res
            ok = bool((pos.cpu().numpy() == lb0).all() and (
                decode_keys(win) == windows(keys, lb0)).all())
        elif kind == "merged":
            ok = bool((res.cpu().numpy() == merged_lb).all())
        elif kind == "merged_scan":
            pos, win = res
            ok = bool((pos.cpu().numpy() == merged_lb).all() and (
                decode_keys(win) == windows(union, merged_lb)).all())
        else:
            pos, packed = res
            want = plan.pack_health_stats(plan.health_stats_expr(
                pos.cpu(), lo.cpu(), hi.cpu(), p.n, p.bounds.max_err,
                N_VALID))
            ok = bool(torch.equal(pos, p.compile("cuda")(q0))
                      and torch.equal(packed.cpu(), want))
        emit({"phase": "transforms", "dataset": TRANSFORMS_CELL,
              "index": p.name, "kind": kind, "batch": BATCH,
              "scan_m": SCAN_M, "delta_keys": DELTA_KEYS, "delta_pad": pad,
              "n_valid": N_VALID, "exact": ok, "launches": launched,
              "check_s": time.perf_counter() - t0}, log)
        check(ok, f"transform {kind} != its oracle")
        check(launched == {"rmi_lookup": 0, "rmi_bounds": 0,
                           "bounded_search": 1},
              f"transform {kind} launched {launched}")
        for k, v in launched.items():
            totals[k] += v


def phase_whole_array(p, q0, dataset, log):
    """B1 over the binary_search plan's windows (the whole array) beside
    ``torch.searchsorted`` on the same 1M queries: the same work, in
    turns."""
    import torch
    from repro_torch.kernels.bounded_search import kernel as bs_kernel
    from repro_torch.kernels.bounded_search import ops as bops

    data, n, m = p.data, p.data.shape[0], q0.shape[0]
    lo, hi = p.bounds.predict(p.bounds.state, q0)
    fns = {"bounded_search": lambda: bs_kernel.launch(data, q0, lo, n + 1, hi),
           "searchsorted": lambda: torch.searchsorted(data, q0)}
    check(torch.equal(fns["bounded_search"]().long(), fns["searchsorted"]()),
          "whole-array B1 != torch.searchsorted")
    times = {k: [] for k in fns}
    for k in [*fns, *reversed(list(fns))]:
        times[k].append(cuda_ms(fns[k]))
    probes = (n + 1).bit_length()
    io = m * (8 + 8 + 8 + 4)
    # every query's probe j lies on level j of one search tree, which has
    # at most 2^j distinct positions: the sectors these queries need at
    # least.  The other rows' rule (32 bytes a probe after a query's first
    # two) counts the shared upper levels once a query, over the bound.
    distinct = sum(min(1 << j, m, n + 1) for j in range(probes))
    b, by = bound(io + distinct * 32, m * probes * 6)
    rule, _ = bound(io + m * (probes - 2) * 32, m * probes * 6)
    rec = {"phase": "timings", "dataset": dataset, "plan": "binary_search",
           "kernel": "bounded_search", "batch": m, "probes_per_query": probes,
           "readings_ms": times,
           "ms": sum(times["bounded_search"]) / 2,
           "plain_ms": cuda_ms(lambda: bops.lower_bound_windows_plain(
               data, q0, lo, n + 1, hi), reps=3, warmup=1),
           "library_ms": sum(times["searchsorted"]) / 2,
           "bound_ms": b, "bound_by": by, "bound_ms_per_query_rule": rule}
    emit(rec, log)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000_000,
                    help="keys of each main-path cell (halve it only if the "
                         "run's time limit forces it)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "chip_smoke.json"))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import gc

    import numpy as np
    import repro_torch.core  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    log: list = []
    t_start = time.perf_counter()
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "numpy": np.__version__}, log)
    build_s = phase_build(log)
    errs = {"rmi_lookup": 0, "rmi_bounds": 0, "bounded_search": 0}
    phase_kernels_vs_plain(dev, args.seed, log, errs)
    totals = {k: 0 for k in kernel_counters()}
    cells = {}
    for ds in MAIN_DATASETS:
        cell = make_cell(dev, ds, args)
        p, e2e = phase_main_path(dev, ds, cell, args, log, totals)
        profile = phase_profile(p, cell["qt"], ds, log,
                                trace=ds == MAIN_DATASETS[0])
        kernels = phase_timings(p, cell["qt"], ds, errs, log)
        data = p.data
        del p
        gc.collect()
        torch.cuda.empty_cache()
        families = phase_families(dev, ds, cell, data, args, log, totals,
                                  errs)
        cells[ds] = {"end_to_end": e2e, "profile": profile,
                     "kernels": kernels, "families": families}
        del cell, data
        gc.collect()
        torch.cuda.empty_cache()
    kernels = cells[MAIN_DATASETS[0]]["kernels"]
    for k in kernels:
        k["launches"] = totals[k["name"]]
        k["max_abs_err"] = max(errs[k["name"]],
                               errs["rmi_bounds"] if k["name"] == "rmi_lookup"
                               else 0)
    emit({"phase": "launches", **totals}, log)
    summary = {"card": smi, "n": args.n, "queries": QUERIES, "batch": BATCH,
               "build_wall_s": build_s, "cells": cells,
               "total_s": time.perf_counter() - t_start, "log": log}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
