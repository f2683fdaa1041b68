"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 lookup_bench/run.py --workload books200M-rmi.uniform \
        --seed 7 --seconds 10 --trace 0

Run from the root of a checkout on a machine with a CUDA card.  The last
line of standard output is the result (JSON); the last lines of standard
error are each compared number beside its limit.  Exits 1 without a
result when there is no card or too few, 2 when JAX or the JAX package
was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the port builds its kernels under the checkout's build/; whatever
    # else compiles caches inside the checkout too, at fixed paths
    cache = ROOT / "build" / "lookup_bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "extensions"))
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from lookup_bench import harness

    bench = harness.load_benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_PROCESS, bench=bench)
    bad = harness.loaded_forbidden()
    if bad:
        print(f"the run loaded {bad}: the benchmark runs the port alone",
              file=sys.stderr)
        return 2
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']} limit {check['is']} "
              f"{check['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
