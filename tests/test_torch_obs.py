"""The port's observability copies against the reference's.

Histograms, rolling windows, the span recorder, per-generation health,
the alert engine and `ServiceMetrics` are stdlib/numpy copies in the
port.  Each scenario below runs the same recorded inputs (an injected
clock where the reference tests use one) through the reference module
and the port module and requires the same readings.
"""
import json
import threading
import types

import numpy as np
import pytest

from repro.obs import alerts as ralerts
from repro.obs import health as rhealth
from repro.obs import trace as rtrace
from repro.obs import windows as rwindows
from repro.serve import common as rcommon
from repro.serve.lookup import metrics as rmetrics
from repro_torch.obs import alerts, health, trace, windows
from repro_torch.serve import common
from repro_torch.serve.lookup import metrics

PAIRS = {
    "windows": (rwindows, windows),
    "trace": (rtrace, trace),
    "health": (rhealth, health),
    "alerts": (ralerts, alerts),
    "metrics": (rmetrics, metrics),
}


def both(name, scenario):
    """Run ``scenario(module)`` on the reference and the port module."""
    ref, port = PAIRS[name]
    return scenario(ref), scenario(port)


def _same(a, b):
    assert json.dumps(a, sort_keys=True, default=repr) == \
        json.dumps(b, sort_keys=True, default=repr)


# ---------------------------------------------------------------------------
# LatencyHistogram / WindowedMetrics
# ---------------------------------------------------------------------------
def test_histogram_matches_reference():
    obs = np.random.default_rng(0).lognormal(-6.0, 1.5, 3_000)

    def run(m):
        h, a, b = m.LatencyHistogram(), m.LatencyHistogram(), \
            m.LatencyHistogram()
        for i, s in enumerate(obs):
            h.record(float(s))
            (a if i % 2 else b).record(float(s))
        a.merge(b)
        probes = [0.0, 1e-9, 1e-6, 3.7e-4, 1.0, 1e4] + h.bounds[::41]
        with pytest.raises(ValueError):
            h.merge(m.LatencyHistogram(n_buckets=100))
        empty = m.LatencyHistogram()
        return {"counts": h.counts, "merged": a.counts, "n": h.n,
                "mean": h.mean, "bounds": h.bounds,
                "q": [h.quantile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)],
                "idx": [h.bucket_index(s) for s in probes],
                "empty": [empty.quantile(0.99), empty.mean]}

    _same(*both("windows", run))


def test_windowed_metrics_match_reference():
    rng = np.random.default_rng(1)
    recs = [(float(s), int(u), float(t)) for s, u, t in zip(
        rng.lognormal(-5.0, 1.2, 2_000), rng.integers(1, 100, 2_000),
        1000.0 + np.cumsum(rng.uniform(0, 0.02, 2_000)))]

    def run(m):
        w = m.WindowedMetrics(slot_s=0.5, n_slots=32, slo_p99_ms=8.0,
                              slo_budget=0.02, clock=lambda: 0.0)
        for s, u, t in recs:
            w.record(s, units=u, t=t)
        t_end = recs[-1][2]
        snaps = [w.snapshot(window_s=ws, t=t_end) for ws in
                 (0.1, 1.0, 5.0, 16.0, 100.0)]
        hist, units, viol, cov = w.merged(4.0, t=t_end)
        # 32 slots later every ring position has been recycled
        w.record(1e-3, t=t_end + 16.0)
        late = w.snapshot(window_s=16.0, t=t_end + 16.0)
        for bad in (dict(slot_s=0), dict(n_slots=0), dict(slo_budget=1.0)):
            with pytest.raises(ValueError):
                m.WindowedMetrics(**bad)
        return {"snaps": snaps, "merged": [hist.counts, units, viol, cov],
                "late": late, "max": w.max_window_s}

    _same(*both("windows", run))


def test_windowed_concurrent_recorders_lose_nothing():
    w = windows.WindowedMetrics(slot_s=60.0, n_slots=4)

    def worker(seed):
        for s in np.random.default_rng(seed).uniform(1e-4, 1e-2, 2_000):
            w.record(float(s))

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert w.merged(window_s=w.max_window_s)[0].n == 16_000


# ---------------------------------------------------------------------------
# SpanRecorder
# ---------------------------------------------------------------------------
def test_trace_export_matches_reference():
    def run(m):
        rec = m.SpanRecorder(capacity=16)
        rec.t_epoch = 100.0                  # the same epoch for both
        rec.add("launch", 100.5, 100.75, cat="serve", kind="read",
                padded=512)
        for i in range(20):                  # overflow: oldest dropped
            rec.instant("admit", cat="admission", t=101.0 + i * 1e-3, rid=i)
        for rid in (7, 8, 9):
            t_submit = 102.0 + rid * 0.01
            rec.request(rid, kind="read", n_keys=32, t_submit=t_submit,
                        t_launch=t_submit + 0.001,
                        t_end=t_submit + 0.002 + rid * 1e-4)
        with m.maybe_span(None, "noop", x=1):
            pass
        with m.maybe_span(rec, "real", cat="lifecycle"):
            pass
        doc = json.loads(json.dumps(rec.to_chrome()))
        # the live span's own clock reading differs between the two runs
        for ev in doc["traceEvents"]:
            if ev.get("name") == "real":
                ev["ts"] = ev["dur"] = 0.0
        return {"doc": doc, "len": len(rec), "dropped": rec.n_dropped,
                "lat": m.SpanRecorder.request_latencies_s(doc),
                "req": len(m.SpanRecorder.request_events(doc))}

    ref, port = both("trace", run)
    _same(ref, port)
    assert port["dropped"] == 25 - 16 and port["req"] == 3
    with pytest.raises(ValueError):
        trace.SpanRecorder(capacity=0)


def test_trace_save_roundtrip(tmp_path):
    rec = trace.SpanRecorder()
    rec.instant("admit", cat="admission", rid=1)
    path = rec.save(str(tmp_path / "t.json"))
    with open(path) as f:
        doc = json.load(f)
    assert doc["otherData"] == {"dropped_spans": 0, "recorded_spans": 1}


# ---------------------------------------------------------------------------
# health
# ---------------------------------------------------------------------------
def _stats_stream(seed=0, k=60):
    """Packed int64[93] vectors as instrumented lookups return them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        disp = rng.integers(0, 50, rhealth.HEALTH_DISP_BUCKETS)
        disp[-1] = rng.integers(0, 2)
        traffic = rng.integers(0, 80, rhealth.HEALTH_TRAFFIC_BUCKETS)
        if i > k // 2:                       # a hot spot late in the run
            traffic[3] += 5_000
        n = int(traffic.sum())
        out.append(np.concatenate([
            [n, int(rng.integers(0, 10 * n)), int(rng.integers(0, 10**6)),
             int(rng.integers(0, 100 * n)), int(rng.integers(0, 9 * n))],
            disp, traffic]).astype(np.int64))
    return out


def test_health_constants_and_helpers_match_reference():
    for name in ("HEALTH_DISP_BUCKETS", "HEALTH_TRAFFIC_BUCKETS",
                 "HEALTH_STATS_SIZE"):
        assert getattr(health, name) == getattr(rhealth, name)
    for j in range(rhealth.HEALTH_DISP_BUCKETS):
        assert health.disp_bucket_edge(j) == rhealth.disp_bucket_edge(j)
    for n in (1, 64, 1_000, 8_001, 200_000, 2**33 + 7):
        np.testing.assert_array_equal(health.build_rank_hist(n),
                                      rhealth.build_rank_hist(n))
    vec = _stats_stream()[0]
    _same(*[{k: np.asarray(v).tolist() for k, v in m.unpack_stats(vec).items()}
            for m in (rhealth, health)])
    with pytest.raises(ValueError):
        health.unpack_stats(np.zeros(health.HEALTH_STATS_SIZE - 1))


def test_generation_health_matches_reference():
    stream = _stats_stream()

    def run(m):
        t = [0.0]
        g = m.GenerationHealth(3, "pgm", 123_457, 142, build_disp_p99=40.0,
                               slot_s=0.5, n_slots=20, clock=lambda: t[0])
        snaps = []
        for i, vec in enumerate(stream):
            g.accumulate(vec if i % 2 else m.unpack_stats(vec))
            t[0] += 0.25
            if i % 10 == 9:
                snaps.append(g.snapshot(window_s=3.0))
        g.note_delta(48, 64)
        return {"snaps": snaps, "record": g.record(window_s=100.0),
                "q": [g.disp_quantile(q) for q in (0.1, 0.5, 0.99, 1.0)],
                "drift": g.drift(window_s=2.0),
                "window": g.traffic_window(1.0).tolist()}

    _same(*both("health", run))


def test_health_monitor_matches_reference():
    stream = _stats_stream(1)

    def gen(version, n_keys=1000, max_err=64):
        p = types.SimpleNamespace(
            name="rmi", bounds=types.SimpleNamespace(max_err=max_err),
            build_displacement_quantile=lambda q: 12.5)
        return types.SimpleNamespace(version=version, n_keys=n_keys, plan=p)

    def run(m):
        mon = m.HealthMonitor(keep=3, clock=lambda: 0.0)
        zero = mon.snapshot()
        for v in range(5):
            mon.on_publish(gen(v, n_keys=1000 + v))
        mon.accumulate(3, stream[0], t=0.0)   # a retired generation
        mon.accumulate(4, stream[1], t=0.0)
        mon.accumulate(999, stream[2], t=0.0)  # unknown: dropped
        mon.note_delta(10, 40)
        return {"zero": zero, "snap": mon.snapshot(window_s=1.0),
                "records": mon.records(window_s=1.0),
                "evicted": [mon.get(v) is None for v in range(5)],
                "current": mon.current().version}

    _same(*both("health", run))


# ---------------------------------------------------------------------------
# alerts
# ---------------------------------------------------------------------------
def test_default_rules_match_reference():
    assert [r.to_dict() for r in alerts.default_rules()] == \
        [r.to_dict() for r in ralerts.default_rules()]
    with pytest.raises(ValueError):
        alerts.AlertRule("x", key="k", op="~")
    with pytest.raises(ValueError):
        alerts.AlertRule("x", key="k", severity="page")


def test_alert_engine_matches_reference(tmp_path):
    """Fire, flap inside the cooldown (suppressed, then late-emitted or
    silently cancelled), multiple rules on one key, sample gates, absent
    keys, and a failing sink: the same events, states and counters."""
    seq = [
        (0.0, {"x": 0.5, "n": 100}), (1.0, {"x": 2.0, "n": 100}),
        (2.0, {"x": 0.1, "n": 100}), (3.0, {"x": 3.0, "n": 100}),
        (5.0, {"x": 3.0, "n": 100}), (12.0, {"x": 3.0, "n": 100}),
        (13.0, {"x": 0.0, "n": 100}), (14.0, {"x": 5.0, "n": 100}),
        (15.0, {"x": 0.0, "n": 100}), (40.0, {"x": 9.0, "n": 5}),
        (41.0, {"n": 100}), (42.0, {"x": 9.0, "n": 100}),
    ]

    def run(m):
        t = [0.0]
        seen = []

        def broken(event):
            raise RuntimeError("sink down")

        rules = (m.AlertRule("hot", key="x", op=">", threshold=1.0,
                             cooldown_s=10.0),
                 m.AlertRule("very_hot", key="x", op=">=", threshold=4.0,
                             severity="critical", cooldown_s=0.0,
                             min_samples_key="n", min_samples=50))
        eng = m.AlertEngine(rules=rules, sinks=(seen.append, broken),
                            clock=lambda: t[0])
        eng.add_sink(m.JsonlSink(str(tmp_path / f"{m.__name__}.jsonl")))
        emitted = []
        for t[0], snap in seq:
            emitted.append(eng.evaluate(snap))
            emitted.append([eng.firing(), eng.firing("critical"),
                            eng.has_critical_firing(), eng.firing_since()])
        doc = eng.to_dict()
        return {"emitted": emitted, "seen": seen, "state": eng.state(),
                "doc": doc, "n_sink_errors": eng.n_sink_errors}

    ref, port = both("alerts", run)
    _same(ref, port)
    assert port["n_sink_errors"] > 0
    with open(tmp_path / "repro_torch.obs.alerts.jsonl") as f:
        assert len(f.readlines()) == len(port["seen"])


def test_default_rules_quiet_on_a_cold_snapshot():
    eng = alerts.AlertEngine(rules=alerts.default_rules(),
                             clock=lambda: 0.0)
    snap = {r.key: 1e9 for r in eng.rules}
    snap.update({r.min_samples_key: 0.0 for r in eng.rules
                 if r.min_samples_key})
    snap["trace_dropped"] = 0.0
    assert eng.evaluate(snap) == [] and eng.firing() == []


# ---------------------------------------------------------------------------
# ServiceMetrics, MonotonicCounter
# ---------------------------------------------------------------------------
def test_service_metrics_match_reference():
    rng = np.random.default_rng(3)
    batches = []
    t = 100.0
    for i in range(300):
        t += float(rng.uniform(1e-4, 5e-3))
        per = [(t - float(rng.uniform(1e-4, 2e-2)), int(rng.integers(1, 65)),
                ("interactive", "batch")[i % 2]) for _ in range(5)]
        batches.append(dict(n_keys=sum(p[1] for p in per), padded=512,
                            n_requests=5, t_oldest_submit=min(
                                p[0] for p in per),
                            t_start=t - 1e-3, t_end=t,
                            per_request=per if i % 3 else None))

    def run(m):
        sm = m.ServiceMetrics(slo_p99_ms=5.0, window_slot_s=0.5,
                              window_slots=64)
        for b in batches:
            sm.observe_batch(**b)
        sm.note_cache(hit=True)
        sm.note_cache(hit=False)
        sm.note_cache(hit=False, warm=True)
        sm.note_slot_depth(3)
        sm.observe_insert_batch(n_keys=500, admitted=480, t_start=t,
                                t_end=t + 0.5)
        sm.observe_compaction(duration_s=0.25)
        sm.observe_compaction_failure()
        sm.set_delta_gauge(delta_keys=48, threshold=64)
        sm.observe_route([3, 0, 5], 16)
        return {"snap": sm.snapshot(), "classes": sm.per_class(),
                "shards": sm.per_shard(),
                "window": sm.windows.snapshot(window_s=2.0, t=t)}

    _same(*both("metrics", run))


def test_monotonic_counter_unique_across_threads():
    c = common.MonotonicCounter(start=5)
    seen = []
    lock = threading.Lock()

    def worker():
        got = [c.next() for _ in range(500)]
        with lock:
            seen.extend(got)

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert sorted(seen) == list(range(5, 2005))
    r = rcommon.MonotonicCounter(start=5)
    assert [r.next() for _ in range(3)] == [5, 6, 7]
