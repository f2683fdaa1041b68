"""Serve driver: token generation on one device, and learned-index lookup
serving over every visible card.

Token mode, the default as in the reference (the paged-KV continuous
batching engine, greedy decoding, weights drawn from a seed):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --requests 8 --max-new 8

runs at the architecture's full width on the CUDA card; ``--smoke`` takes
its reduced config and ``--device cpu`` asks for the CPU.  Every family
is served: dense, vlm, moe, ssm, hybrid and encdec (whisper-tiny, whose
cached encoder states stay zero, as the reference's engine leaves them).

Lookup mode:

    PYTHONPATH=src python -m repro_torch.launch.serve --mode lookup \\
        --dataset amzn --requests 200 --keys-per-request 64

Routes through `repro_torch.serve.lookup`: admission, micro-batching and
plan-compiled dispatch over every visible CUDA card, as the reference's
driver serves over every local device (each batch split into one slice a
card, each card holding a replica of the index); ``--device cuda:N`` pins
one card, and ``--device cpu`` asks for the CPU, where the kernels' plain
versions run.  ``--spec`` takes one
`IndexSpec` as JSON, which is how the backend is chosen:

    --spec '{"index": "rmi", "hyper": {"branching": 4096}, "backend": "cuda"}'

``--executor`` picks the dispatch engine: ``async`` (the default, as in
the reference: CUDA graphs of the plan's callables in an executable
cache, a slot ring of in-flight batches) or ``sync`` (the serial loop).
``--shards N`` range-routes the key space over N per-shard indexes
(scatter/gather dispatch; each (shard, replica) lane on its own card,
round robin, and on one card every lane runs on it) and
``--replicas R`` gives each shard R read lanes.  ``--autotune-daemon``
starts the shadow retuner beside the service and ``--autotune-store
DIR`` persists its tuned specs.

Ops surface: ``--metrics-port`` starts the stdlib HTTP exporter (GET
/metrics for Prometheus text, /metrics.json, /trace.json, /health.json,
/alerts.json, /healthz), ``--metrics-jsonl`` appends a metrics snapshot a
second to a file, ``--trace-out`` records the run and writes a
Chrome-trace JSON, ``--slo-p99-ms`` arms the windowed error-budget
tracking, and index health is instrumented by default (``--no-health``
turns it off): the summary prints the health line (displacement p99
against the error bound, drift) and the alert verdict.  ``--doctor``
exits nonzero when an alert is firing at the end of the run, an answer
is wrong, or the autotune daemon thread died during the run.

The port of the reference's `repro.launch.serve`.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np


def run_tokens(args, cfg) -> None:
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    t0 = time.time()
    params = M.init_params(cfg, seed=0, device=args.device)
    engine = ServeEngine(cfg, params, max_batch=args.max_batch,
                         max_seq=args.max_seq, device=args.device)
    print(f"serving {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype}) on {engine.device}, weights from "
          f"seed 0 in {time.time() - t0:.2f}s")

    rng = np.random.default_rng(0)
    t0 = time.time()
    rids = [engine.submit(
        list(rng.integers(2, cfg.vocab, int(rng.integers(3, 10)))),
        max_new=args.max_new) for _ in range(args.requests)]
    outs = engine.run(max_steps=args.requests * (args.max_new + 12))
    dt = time.time() - t0
    n_tok = sum(len(v) for v in outs.values())
    for rid in rids:
        print(f"request {rid}: {outs[rid]}")
    print(f"\n{n_tok} tokens for {len(rids)} requests in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s, continuous batching over "
          f"{args.max_batch} slots); kv pool util now "
          f"{engine.kv.alloc.utilization:.2f}")


def run_lookup(args) -> None:
    from repro_torch.core import base
    from repro_torch.core.spec import IndexSpec
    from repro_torch.data import sosd
    from repro_torch.obs.export import JsonlMetricsLogger, MetricsServer
    from repro_torch.serve.lookup import (LookupService, LookupServiceConfig,
                                          default_spec)
    from repro_torch.serve.lookup.dispatch import distinct

    keys = sosd.generate(args.dataset, args.n_keys, seed=1)
    # --spec takes one declarative IndexSpec (JSON) over the index name
    sp = (IndexSpec.from_json(args.spec) if args.spec
          else default_spec(args.index))
    at_cfg = None
    if args.autotune_daemon or args.autotune_store:
        from repro_torch.autotune import AutotuneConfig
        at_cfg = AutotuneConfig(daemon=args.autotune_daemon,
                                store_dir=args.autotune_store)
    t0 = time.time()
    svc = LookupService(keys, LookupServiceConfig(
        spec=sp, max_batch=args.max_batch,
        deadline_ms=args.deadline_ms, executor=args.executor,
        shards=args.shards, replicas=args.replicas,
        trace=bool(args.trace_out), slo_p99_ms=args.slo_p99_ms,
        health=not args.no_health, autotune=at_cfg), device=args.device)
    n_dev = len(distinct(svc.devices))
    print(f"serving spec: {svc.generation.spec.to_json()} "
          f"(executor={args.executor}, "
          f"device={','.join(str(d) for d in svc.devices)}, "
          f"built in {time.time() - t0:.2f}s)")
    topo = getattr(svc.generation, "topology", None)
    if topo is not None:
        print(f"topology: {topo.describe()}")
    q = sosd.make_queries(keys, args.requests * args.keys_per_request, seed=2)

    with contextlib.ExitStack() as stack:
        if args.metrics_port is not None:
            server = stack.enter_context(
                MetricsServer(svc, port=args.metrics_port,
                              window_s=args.window_s))
            print(f"metrics: http://127.0.0.1:{server.port}/metrics "
                  f"(+ /metrics.json, /trace.json, /health.json, "
                  f"/alerts.json, /healthz)")
        if args.metrics_jsonl:
            stack.enter_context(JsonlMetricsLogger(
                svc, args.metrics_jsonl, interval_s=1.0,
                window_s=args.window_s))
        t0 = time.time()
        at_dead = False
        with svc:
            futs = [svc.submit(q[i * args.keys_per_request:
                                 (i + 1) * args.keys_per_request])
                    for i in range(args.requests)]
            outs = [f.result(timeout=120.0) for f in futs]
            # probe the retuner thread BEFORE stop() shuts it down on
            # purpose: --doctor must tell "died" from "stopped"
            at_dead = (svc.autotune is not None and svc.autotune.cfg.daemon
                       and not svc.autotune.alive)
        dt = time.time() - t0

    got = np.concatenate(outs)
    exact = bool(np.array_equal(got, base.lower_bound_oracle(keys, q)))
    snap = svc.metrics.snapshot()
    print(f"{len(q)} lookups / {args.requests} requests in {dt:.2f}s over "
          f"{svc.dispatcher.n_shards} shard(s) on {n_dev} device(s): "
          f"{args.requests / dt:.1f} requests/s, "
          f"{snap['lookups_per_s']/1e3:.1f} klookups/s, "
          f"{snap['batches']} batches, "
          f"occupancy {snap['mean_occupancy']:.2f}, "
          f"batch p99 {snap['p99_batch_ms']:.2f}ms, "
          f"queue p99 {snap['p99_queue_ms']:.2f}ms, "
          f"request p50 {snap['p50_request_ms']:.2f}ms, "
          f"request p99 {snap['p99_request_ms']:.2f}ms, "
          f"cache hit rate {snap['cache_hit_rate']:.2f}")
    w = svc.metrics.windowed(args.window_s)
    line = (f"windowed({w['window_s']:.0f}s): p50 {w['p50_ms']:.2f}ms, "
            f"p99 {w['p99_ms']:.2f}ms, "
            f"{w['lookups_per_s']/1e3:.1f} klookups/s")
    if args.slo_p99_ms is not None:
        line += (f", SLO p99<{args.slo_p99_ms:.0f}ms: "
                 f"{w['slo_violations']} violations, "
                 f"budget burn {w['slo_budget_burn']:.2f}")
    print(line)
    if args.trace_out:
        svc.recorder.save(args.trace_out)
        print(f"wrote Chrome trace ({len(svc.recorder)} spans, "
              f"{svc.recorder.n_dropped} dropped) to {args.trace_out}")
    if args.metrics_jsonl:
        print(f"wrote metrics JSONL to {args.metrics_jsonl}")
    # health verdict: evaluate the alert rules over the whole run
    events = svc.check_alerts(window_s=max(args.window_s, dt + 1.0))
    firing = svc.alerts.firing()
    if not args.no_health:
        h = svc.health_snapshot(max(args.window_s, dt + 1.0))
        gen = svc.generation
        max_err = int(getattr(gen, "max_err", gen.plan.bounds.max_err))
        print(f"health: disp p99 {h['disp_p99']:.0f} of max_err "
              f"{max_err} "
              f"(bound utilization {h['bound_utilization_p99']:.2f}, "
              f"{h['disp_p99_ratio']:.2f}x build), "
              f"last-mile steps {h['mean_last_mile_steps']:.1f}, "
              f"drift TV {h['drift_tv']:.3f} over {h['drift_n']:.0f} "
              f"lookups")
    for e in events:
        print(f"alert {e['rule']} {e['state']}: {e['key']}={e['value']:.3g} "
              f"({e['op']} {e['threshold']:.3g}) — {e['action']}")
    print("alerts: " + (", ".join(firing) if firing else "none firing"))
    if svc.autotune is not None:
        st = svc.autotune.status()
        lt = st["last_trigger"]
        daemon_state = ("DEAD" if at_dead
                        else "up" if st["daemon"] else "off")
        print(f"autotune: daemon={daemon_state} "
              f"triggered={st['n_triggered']} swapped={st['n_swapped']} "
              f"rejected={st['n_rejected']}, "
              f"last trigger {lt['rule'] if lt else 'none'}, "
              f"last verdict {st['last_verdict'] or 'none'}")
        if at_dead:
            print(f"autotune: retuner thread died: "
                  f"{st['last_error'] or 'unknown error'}")
    print(f"exact vs lower_bound oracle: {exact}")
    if args.doctor and (firing or not exact or at_dead):
        raise SystemExit(1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("tokens", "lookup"), default="tokens",
                    help="token generation (default) or lookup serving")
    # token mode
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    # shared / lookup mode
    ap.add_argument("--max-batch", type=int, default=None,
                    help="decode slots (tokens, default 4) or keys per "
                         "dispatch (lookup, the flush trigger, default "
                         "2048)")
    ap.add_argument("--dataset", default="amzn",
                    choices=sorted(("amzn", "face", "osm", "wiki")))
    ap.add_argument("--index", default="rmi")
    ap.add_argument("--spec", default=None,
                    help="IndexSpec JSON (overrides --index), e.g. "
                         '\'{"index": "pgm", "hyper": {"eps": 32}, '
                         '"backend": "cuda"}\'')
    ap.add_argument("--n-keys", type=int, default=200_000)
    ap.add_argument("--keys-per-request", type=int, default=64)
    ap.add_argument("--deadline-ms", type=float, default=2.0)
    ap.add_argument("--executor", choices=("sync", "async"), default="async",
                    help="lookup dispatch engine: the continuous-batching "
                         "async executor (default) or the serial sync loop")
    ap.add_argument("--shards", type=int, default=1,
                    help="range-routed serving topology: partition the "
                         "key space into this many equal-count ranges "
                         "with per-shard indexes and scatter/gather "
                         "dispatch (1 = broadcast)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="read fan-out per shard (routed topology only): "
                         "each shard's lookups round-robin over this many "
                         "replica lanes")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: token mode "
                         "the CUDA card, lookup mode every visible CUDA "
                         "card; 'cuda:N' pins one, 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="start the HTTP metrics endpoint on this port "
                         "(0 = ephemeral): /metrics Prometheus text, "
                         "/metrics.json, /trace.json, /health.json, "
                         "/alerts.json, /healthz")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append one metrics snapshot per second to this "
                         "JSONL file")
    ap.add_argument("--trace-out", default=None,
                    help="record request/lifecycle spans and write a "
                         "Chrome-trace JSON here")
    ap.add_argument("--slo-p99-ms", type=float, default=None,
                    help="p99 latency SLO target: windowed snapshots "
                         "report violations + error-budget burn")
    ap.add_argument("--window-s", type=float, default=10.0,
                    help="rolling window the summary reports over")
    ap.add_argument("--no-health", action="store_true",
                    help="disable index-health instrumentation; reads "
                         "dispatch the plain lookup")
    ap.add_argument("--autotune-daemon", action="store_true",
                    help="start the shadow-retuner daemon: workload-drift, "
                         "error or SLO alerts trigger an off-hot-path "
                         "retune, verified bit-exact against the oracle "
                         "before hot-swapping")
    ap.add_argument("--autotune-store", default=None,
                    help="spec-artifact store directory: tuned specs "
                         "persist keyed by (dataset fingerprint, byte "
                         "budget, workload signature) so a restart on "
                         "the same workload skips the ladder sweep")
    ap.add_argument("--doctor", action="store_true",
                    help="one-shot health check: exit 1 when any alert "
                         "is firing, the oracle check fails, or the "
                         "autotune daemon thread died during the run")
    args = ap.parse_args(argv)
    if args.mode == "lookup":
        if args.max_batch is None:
            args.max_batch = 2048
        run_lookup(args)
        return
    if args.max_batch is None:
        args.max_batch = 4
    from repro_torch.configs import ARCHS, get, get_smoke
    if args.arch not in ARCHS:
        ap.error(f"unknown --arch {args.arch!r}; known: {sorted(ARCHS)}")
    run_tokens(args, get_smoke(args.arch) if args.smoke else get(args.arch))


if __name__ == "__main__":
    main()
