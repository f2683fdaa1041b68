"""Serve learned-index lookups in the PyTorch port: async admission,
micro-batching, a hot swap, on every visible card.

    PYTHONPATH=src python examples/torch_serve_lookup.py [--device cpu]

The port's counterpart of `examples/serve_lookup.py`.  Four concurrent
clients stream key lookups at a `LookupService` on the async executor
(CUDA graphs in a warmed executable cache, launch without waiting, a
bounded slot ring) while it micro-batches them; mid-stream the key set is
rebuilt and hot-swapped without draining a single in-flight batch.
Without ``--device`` the service serves over every visible CUDA card:
each batch is split into one slice a card, each card answering from its
own replica of the index, and the slices are joined back in admission
order.  ``--device cuda:N`` pins one card and ``--device cpu`` runs the
kernels' plain versions on the CPU.

Tracing is on: every request is a span from admission to completion, the
hot swap shows up as lifecycle spans, and the run is written out as a
Chrome-trace JSON (chrome://tracing or https://ui.perfetto.dev).  Every
answer is checked against ``np.searchsorted`` on the key set it was
served from.
"""
import argparse
import os
import tempfile
import threading
import time

import numpy as np

from repro_torch.core.spec import IndexSpec
from repro_torch.data import sosd
from repro_torch.serve.lookup import LookupService, LookupServiceConfig

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device (default: every visible CUDA card)")
ap.add_argument("--n-keys", type=int, default=100_000)
ap.add_argument("--requests-per-client", type=int, default=40)
ap.add_argument("--trace-out", default=os.path.join(
    tempfile.gettempdir(), "torch_serve_lookup_trace.json"))
args = ap.parse_args()

N_CLIENTS = 4
KEYS_PER_REQUEST = 64
SLO_P99_MS = 25.0

keys = sosd.generate("amzn", args.n_keys, seed=1)
svc = LookupService(keys, LookupServiceConfig(
    spec=IndexSpec("rmi", dict(branching=2048)),
    max_batch=1024, deadline_ms=1.0, executor="async",
    trace=True, slo_p99_ms=SLO_P99_MS), device=args.device)
print(f"serving {args.n_keys} amzn keys on "
      f"{', '.join(str(d) for d in svc.devices)} "
      f"({svc.dispatcher.n_shards} slice(s) a batch)")
key_sets = {svc.generation.version: keys}   # the key set of each version
errors = []


def client(cid: int):
    rng = np.random.default_rng(cid)
    for _ in range(args.requests_per_client):
        v0 = svc.generation.version         # the key set this client targets
        q = sosd.make_queries(key_sets[v0], KEYS_PER_REQUEST,
                              seed=int(rng.integers(1 << 30)))
        pos = svc.submit(q).result(timeout=60.0)
        # a swap may land after the sample: the answer is then the newer
        # generation's
        v1 = svc.generation.version
        if not any(np.array_equal(pos, np.searchsorted(key_sets[v], q))
                   for v in (v0, v1)):
            errors.append(cid)
        time.sleep(0.002)


with svc:                               # dispatch and completion threads
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(N_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()

    time.sleep(0.15)                    # mid-stream: rebuild + hot swap
    keys2 = sosd.generate("wiki", args.n_keys, seed=2)
    v0 = svc.generation.version
    t_swap = time.perf_counter()
    key_sets[v0 + 1] = keys2            # the version the swap publishes
    svc.swap_keys(keys2)
    swap_ms = (time.perf_counter() - t_swap) * 1e3
    print(f"hot-swapped amzn -> wiki (generation {v0} -> "
          f"{svc.generation.version}) in {swap_ms:.0f}ms, no drain")

    for t in threads:
        t.join()
    dt = time.perf_counter() - t0

snap = svc.metrics.snapshot()
n_req = N_CLIENTS * args.requests_per_client
print(f"\n{n_req} requests x {KEYS_PER_REQUEST} keys from {N_CLIENTS} "
      f"clients in {dt:.2f}s")
print(f"  {snap['batches']} dispatched batches, "
      f"occupancy {snap['mean_occupancy']:.2f}, "
      f"{snap['lookups_per_s']/1e3:.1f} klookups/s")
print(f"  batch latency mean {snap['mean_batch_ms']:.2f}ms / "
      f"p99 {snap['p99_batch_ms']:.2f}ms; "
      f"queue p99 {snap['p99_queue_ms']:.2f}ms; "
      f"request p99 {snap['p99_request_ms']:.2f}ms")
print(f"  executable cache: hit rate {snap['cache_hit_rate']:.2f} "
      f"({snap['cache_hits']} hits, {snap['cache_misses']} misses, "
      f"{snap['warm_compiles']} warm compiles); "
      f"in-flight slots mean {snap['mean_inflight_slots']:.2f} / "
      f"max {snap['max_inflight_slots']}")

# the p99 of the trailing window, not of all time, and the SLO's
# error-budget burn an operator would page on
w = svc.metrics.windowed(window_s=10.0)
print(f"  windowed({w['window_s']:.0f}s): p50 {w['p50_ms']:.2f}ms / "
      f"p99 {w['p99_ms']:.2f}ms, {w['lookups_per_s']/1e3:.1f} klookups/s; "
      f"SLO p99<{SLO_P99_MS:.0f}ms: {w['slo_violations']} violations, "
      f"budget burn {w['slo_budget_burn']:.2f}")

svc.recorder.save(args.trace_out)
print(f"  trace: {len(svc.recorder)} spans ({svc.recorder.n_dropped} "
      f"dropped) -> {args.trace_out}")

print(f"  wrong answers: {len(errors)}")
assert not errors
