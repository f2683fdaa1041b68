#!/usr/bin/env python3
"""Drive the PyTorch port's learned-index read path on one NVIDIA card.

    python3 chip_smoke.py [--n 200000000] [--seed 0] [--out PATH]

Builds both hand-written CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain torch version bit for bit, then runs the main path
at full size on two surrogates: ``amzn``, whose RMI windows span much of
the array, and ``wiki``, whose windows are narrow.  Each gets an RMI with
2^18 stage-2 models built through ``spec.build`` and a ``LookupPlan``
compiled for the ``cuda`` backend (fused and unfused) and the ``torch``
backend; 10M queries in batches of 1M, every answer held against
``np.searchsorted`` on the host.  Per-kernel times and the spread of the
fused path's window widths follow each.  One JSON line per phase; any
failure exits nonzero.  The last line is the device summary
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
    check(set(KERNEL_SOURCES) <= set(info), f"kernels built: {sorted(info)}")
    return wall


def phase_kernels_vs_plain(dev, seed, log, errs):
    """Both kernels against their plain versions on every surrogate."""
    import numpy as np
    import torch
    from repro_torch.data import sosd
    from repro_torch.kernels.bounded_search import ops as bops
    from repro_torch.kernels.common import encode_keys
    from repro_torch.kernels.rmi_lookup import ops as rops

    def diff(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

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
            torch.cuda.synchronize()
            e2 = max(diff(lo, plo), diff(hi, phi))
            e1 = diff(pos, ppos)
            errs["rmi_lookup"] = max(errs["rmi_lookup"], e2)
            errs["bounded_search"] = max(errs["bounded_search"], e1)
            valid = bool(((lo <= lb) & (lb <= hi)).all())
            exact = bool((pos.long() == lb).all())
            emit({"phase": "kernels_vs_plain", "dataset": ds, "n": n, "m": m,
                  "branching": branching, "max_err": st.max_err,
                  "rmi_lookup_max_abs_err": e2,
                  "bounded_search_max_abs_err": e1,
                  "bounds_valid": valid, "lb_exact": exact}, log)
            check(e1 == 0 and e2 == 0 and valid and exact,
                  f"kernel vs plain on {ds}/{branching}")

    # the TPU kernel's two special cases: a window wider than its 2048-key
    # tile, and every query in one tile (its capacity overflow)
    rng = np.random.default_rng(seed)
    keys = sosd.generate("amzn", n, seed=seed)
    data = encode_keys(keys, dev)
    cases = {}
    width = 5_000
    q = keys[rng.integers(0, n, m)]
    lb = np.searchsorted(keys, q)
    cases["wide_window"] = (q, np.maximum(lb - rng.integers(0, width - 1, m),
                                          0), width)
    q = keys[rng.integers(0, 2_048, m)]
    lb = np.searchsorted(keys, q)
    cases["one_tile"] = (q, np.maximum(lb - 10, 0), 64)
    for case, (q, lo, width) in cases.items():
        qt = encode_keys(q, dev)
        lo_t = torch.from_numpy(lo.astype(np.int32)).to(dev)
        pos = bops.lower_bound_windows(data, qt, lo_t, width)
        ppos = bops.lower_bound_windows_plain(data, qt, lo_t, width)
        e1 = diff(pos, ppos)
        errs["bounded_search"] = max(errs["bounded_search"], e1)
        exact = bool((pos.cpu().numpy() == np.searchsorted(keys, q)).all())
        emit({"phase": "kernels_vs_plain", "case": case, "n": n, "m": m,
              "max_width": width, "bounded_search_max_abs_err": e1,
              "lb_exact": exact}, log)
        check(e1 == 0 and exact, f"bounded_search vs plain on {case}")


def phase_main_path(dev, dataset, args, log):
    """The port's read path at full size, through its public entry points.
    Launch counts are zeroed just before the runs and read just after."""
    import numpy as np
    import torch
    from repro_torch.core import plan, spec
    from repro_torch.data import sosd
    from repro_torch.kernels.bounded_search import kernel as bs_kernel
    from repro_torch.kernels.common import encode_keys
    from repro_torch.kernels.rmi_lookup import kernel as rmi_kernel

    t0 = time.perf_counter()
    keys = sosd.generate(dataset, args.n, seed=args.seed)
    t_gen = time.perf_counter() - t0
    queries = sosd.make_queries(keys, QUERIES, seed=args.seed)
    t0 = time.perf_counter()
    lb = np.searchsorted(keys, queries)
    t_oracle = time.perf_counter() - t0
    qt = encode_keys(queries, dev)
    del queries

    torch.cuda.reset_peak_memory_stats()
    rmi_kernel.launch.launches = 0
    bs_kernel.launch.launches = 0
    t0 = time.perf_counter()
    build = spec.build(spec.IndexSpec("rmi", {"branching": BRANCHING}), keys,
                       device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    p = plan.lower(build, encode_keys(keys, dev))
    del keys
    emit({"phase": "main_path_setup", "dataset": dataset, "n": args.n,
          "queries": QUERIES, "batch": BATCH, "branching": BRANCHING,
          "max_err": p.bounds.max_err, "size_bytes": build.size_bytes,
          "generate_s": t_gen, "build_s": t_build,
          "host_oracle_s": t_oracle}, log)

    runs = [("cuda", True), ("cuda", False), ("torch", None), ("cuda", True)]
    e2e = {}
    for backend, fused in runs:
        t0 = time.perf_counter()
        fn = p.compile(backend, fused=fused)
        torch.cuda.synchronize()
        t_compile = time.perf_counter() - t0
        fn(qt[:BATCH])                            # warm-up batch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [fn(qt[i:i + BATCH]) for i in range(0, QUERIES, BATCH)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = torch.cat(outs).cpu().numpy()
        exact = bool(got.shape == lb.shape and (got == lb).all())
        label = backend if fused is None else \
            f"{backend}_{'fused' if fused else 'unfused'}"
        rec = {"phase": "main_path", "dataset": dataset, "backend": label,
               "last_mile": p.last_mile if backend == "torch" else "kernel",
               "compile_s": t_compile, "seconds": dt,
               "ns_per_lookup": dt / QUERIES * 1e9,
               "lookups_per_s": QUERIES / dt, "exact": exact}
        e2e.setdefault(label, rec)
        emit(rec, log)
        check(exact, f"main path {dataset}/{label} != np.searchsorted")
    launches = {"rmi_lookup": rmi_kernel.launch.launches,
                "bounded_search": bs_kernel.launch.launches}
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "main_path_launches", "dataset": dataset, **launches,
          "peak_device_bytes": peak}, log)
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the {dataset} main path")
    return p, qt, launches, e2e


def window_spread(lo, hi, max_err: int) -> dict:
    """Spread of the fused path's window widths ``hi - lo + 1`` over one
    batch, and the trip counts a search sized per query, or per warp of 32
    neighbouring queries, would need beside the ``lb_steps(max_err)`` that
    the bounded-search kernel runs for every query."""
    import torch
    from repro_torch.kernels.common import lb_steps

    w = (hi.long() - lo.long() + 1).clamp(min=1)
    ws = torch.sort(w).values
    m = ws.numel()

    def steps(x):  # lb_steps elementwise
        return torch.ceil(torch.log2((x.double() + 1).clamp(min=2))) + 1

    warp_max = w[: m // 32 * 32].view(-1, 32).max(dim=1).values
    return {
        **{f"p{int(f * 100)}": int(ws[min(int(f * m), m - 1)])
           for f in (0.5, 0.9, 0.99)},
        "max": int(ws[-1]), "max_err": max_err,
        "share_above_2048": float((w > 2048).double().mean()),
        "share_above_max_err_over_8": float(
            (w > max_err // 8).double().mean()),
        "lb_steps_max_err": lb_steps(max_err),
        "mean_lb_steps_per_query": float(steps(w).mean()),
        "mean_lb_steps_per_warp": float(steps(warp_max).mean()),
    }


def phase_timings(p, qt, dataset, launches, errs, log):
    """Per-kernel device time at the main path's shapes, beside the plain
    version, the one-call library yardstick, and the bound."""
    import torch
    from repro_torch.kernels.bounded_search import kernel as bs_kernel
    from repro_torch.kernels.bounded_search import ops as bops
    from repro_torch.kernels.common import lb_steps
    from repro_torch.kernels.rmi_lookup import kernel as rmi_kernel
    from repro_torch.kernels.rmi_lookup import ops as rops

    st = p._cache["_rmi_f32_state"]
    data = p.data
    q0 = qt[:BATCH].contiguous()
    m = q0.shape[0]
    lo, hi = rmi_kernel.launch(st, q0)
    lo_only, no_hi = rmi_kernel.launch(st, q0, with_hi=False)
    plo, phi = rops.rmi_bounds_plain(st, q0)
    steps = lb_steps(st.max_err)
    pos = bs_kernel.launch(data, q0, lo, st.max_err, steps)
    ppos = bops.lower_bound_windows_plain(data, q0, lo, st.max_err)
    torch.cuda.synchronize()
    check(torch.equal(lo, plo) and torch.equal(hi, phi)
          and torch.equal(lo_only, lo) and no_hi is None,
          f"rmi_lookup vs plain at {dataset} main-path shapes")
    check(torch.equal(pos, ppos),
          f"bounded_search vs plain at {dataset} main-path shapes")

    kernels = []
    # the fused path's B2 writes lo only (4 bytes a query)
    b2_bound, b2_by = bound(m * (8 + 4) + st.branching * 12, m * 12)
    kernels.append({
        "name": "rmi_lookup", "route": "cuda",
        "source": KERNEL_SOURCES["rmi_lookup"][0],
        "replaces": KERNEL_SOURCES["rmi_lookup"][1],
        "launches": launches["rmi_lookup"],
        "max_abs_err": errs["rmi_lookup"],
        "ms": cuda_ms(lambda: rmi_kernel.launch(st, q0, with_hi=False)),
        "plain_ms": cuda_ms(lambda: rops.rmi_bounds_plain(st, q0)),
        "bound_ms": b2_bound, "bound_by": b2_by, "library_ms": None})
    b1_bound, b1_by = bound(m * (8 + 4 + 4) + m * max(steps - 2, 0) * 32,
                            m * steps * 6)
    kernels.append({
        "name": "bounded_search", "route": "cuda",
        "source": KERNEL_SOURCES["bounded_search"][0],
        "replaces": KERNEL_SOURCES["bounded_search"][1],
        "launches": launches["bounded_search"],
        "max_abs_err": errs["bounded_search"],
        "ms": cuda_ms(lambda: bs_kernel.launch(data, q0, lo, st.max_err,
                                               steps)),
        "plain_ms": cuda_ms(lambda: bops.lower_bound_windows_plain(
            data, q0, lo, st.max_err)),
        "bound_ms": b1_bound, "bound_by": b1_by,
        "library_ms": cuda_ms(lambda: torch.searchsorted(data, q0))})
    emit({"phase": "timings", "dataset": dataset, "batch": m,
          "branching": st.branching, "lb_steps": steps,
          "rmi_lookup_with_hi_ms": cuda_ms(lambda: rmi_kernel.launch(st, q0)),
          "window": window_spread(lo, hi, st.max_err),
          "kernels": {k["name"]: {f: k[f] for f in (
              "launches", "ms", "plain_ms", "bound_ms", "library_ms")}
              for k in kernels}}, log)
    return kernels


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
    errs = {"rmi_lookup": 0, "bounded_search": 0}
    phase_kernels_vs_plain(dev, args.seed, log, errs)
    cells = {}
    for ds in MAIN_DATASETS:
        p, qt, launches, e2e = phase_main_path(dev, ds, args, log)
        cells[ds] = {"end_to_end": e2e,
                     "kernels": phase_timings(p, qt, ds, launches, errs, log)}
        del p, qt
        gc.collect()
        torch.cuda.empty_cache()
    kernels = cells[MAIN_DATASETS[0]]["kernels"]
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
