"""Run one cell several times, each run a process of its own as the
benchmark's check runs it, and print each metric's spread.

    python3 lookup_bench/spread.py --workload books200M-rmi.uniform \
        --seeds 101,102,103,104,105,106 --sets 2 --out runs.jsonl

Each set runs every seed once, in order; every run's result line (or its
failure) is appended to ``--out`` as it ends.  The spread of a metric in
a set is the distance between its first and third quartiles
(`statistics.quantiles`, n=4) over its median.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else float("nan"), med


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one run each a set")
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=None,
                    help="default: BENCHMARK.json's run_seconds")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=1200)
    args = ap.parse_args(argv)
    seconds = args.seconds
    if seconds is None:
        with open(ROOT / "BENCHMARK.json") as f:
            seconds = json.load(f)["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    runs = []
    for s in range(args.sets):
        for seed in seeds:
            cmd = [sys.executable, "lookup_bench/run.py", "--workload",
                   args.workload, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(args.trace)]
            t = time.perf_counter()
            try:
                out = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                     text=True, timeout=args.timeout)
                rc, stdout, stderr = out.returncode, out.stdout, out.stderr
            except subprocess.TimeoutExpired as e:
                rc, stdout, stderr = 124, e.stdout or "", e.stderr or ""
                stdout = stdout if isinstance(stdout, str) else \
                    stdout.decode(errors="replace")
                stderr = stderr if isinstance(stderr, str) else \
                    stderr.decode(errors="replace")
            lines = stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1]) if rc == 0 else None
            except (IndexError, json.JSONDecodeError):
                result = None
            rec = {"set": s, "seed": seed, "rc": rc,
                   "wall_s": time.perf_counter() - t, "result": result,
                   "stderr_tail": stderr[-3000:]}
            runs.append(rec)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            brief = {k: round(v["value"], 6) for k, v in
                     (result or {}).get("metrics", {}).items()}
            print(f"set {s} seed {seed} rc {rc} "
                  f"correct {(result or {}).get('correct')} {brief}",
                  flush=True)
    for s in range(args.sets):
        done = [r["result"] for r in runs if r["set"] == s and r["result"]]
        names = sorted({k for r in done for k in r["metrics"]})
        for name in names:
            vals = [r["metrics"][name]["value"] for r in done
                    if name in r["metrics"]]
            if len(vals) >= 2:
                sp, med = spread(vals)
                print(f"set {s} {name}: median {med!r} spread {sp!r} "
                      f"over {len(vals)} runs", flush=True)
    return 0 if all(r["rc"] == 0 and r["result"]["correct"]
                    for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
