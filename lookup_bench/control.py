"""The readings that the limit of ``correct`` is set from: a cell run
with the control, or with a planted fault, in the program's place.

    python3 lookup_bench/control.py --workload books200M-rmi.uniform \
        --seeds 1,2,3 --fault control --seconds 2

``control`` is the reference computed with keys and queries rounded to
float32 (`reference.lower_bound_f32`), which breaks the exact rank every
configuration guarantees; the port builds nothing.  The faults break the
port's own timed path where it answers: ``altered`` adds one to one
answer of each batch, ``half`` answers only the first half of each batch,
``stale`` returns the previous batch's answers.  Each seed runs in this
process; one result line each, with the compared numbers.  The benchmark's
own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def planted(fault: str):
    """``wrap`` for `harness.run_cell` that plants ``fault``."""
    import torch

    from lookup_bench import codec, reference

    def control(fn, inputs):
        held = {}

        def run(q):
            if "keys" not in held:      # the raw keys wait on the host
                held["keys"] = inputs["raw_keys"].to(q.device)
            return reference.lower_bound_f32(held["keys"], codec.decode(q))
        return run

    def altered(fn, inputs):
        def run(q):
            out = fn(q).clone()
            out[q.shape[0] // 3] += 1
            return out
        return run

    def half(fn, inputs):
        return lambda q: fn(q[:q.shape[0] // 2].contiguous())

    def stale(fn, inputs):
        last = []

        def run(q):
            out = fn(q)
            prev = last[0] if last else torch.zeros_like(out)
            last[:] = [out]
            return prev
        return run

    return {"control": control, "altered": altered, "half": half,
            "stale": stale}[fault]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default="control",
                    choices=("control", "altered", "half", "stale"))
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from lookup_bench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    for seed in (int(s) for s in args.seeds.split(",")):
        result = harness.run_cell(
            args.workload, seed, args.seconds, False,
            torch.device("cuda", 0), time.perf_counter(),
            wrap=planted(args.fault), program=args.fault != "control")
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "correct": result["correct"],
                          "failed": result["failed"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
