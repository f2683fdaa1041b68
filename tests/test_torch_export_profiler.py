"""The port's exporters and stage profiler against the reference's.

`prometheus_text`, `metrics_payload` and `MetricsServer.render_prometheus`
render the same snapshot exactly as `repro.obs.export` does; the HTTP
endpoints and the JSONL logger behave as in `tests/test_obs.py`, here
over a live port service; a traced service reconciles request ids and
p99 on both executors; `proxy_decomposition` equals the reference's to
1e-9 on the same build and widths, and the measured split has the
reference's shape (on the CPU its times are the host clock).
"""
import jax

jax.config.update("jax_enable_x64", True)

import json
import math
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.core import spec as rspec
from repro.data import sosd as rsosd
from repro.obs import export as rexport
from repro.obs import profiler as rprofiler
from repro_torch.core import plan as plan_mod
from repro_torch.core import spec
from repro_torch.data import sosd
from repro_torch.kernels.common import encode_keys
from repro_torch.obs import profiler
from repro_torch.obs.export import (JsonlMetricsLogger, MetricsServer,
                                    metrics_payload, prometheus_text)
from repro_torch.obs.trace import SpanRecorder
from repro_torch.serve.lookup import LookupService, LookupServiceConfig

CPU = "cpu"


# ---------------------------------------------------------------------------
# exporters: the reference's rendering of the same snapshot
# ---------------------------------------------------------------------------
SNAPSHOTS = [
    {"p99_ms": 1.5, "n": 3, "name": "rmi", "ok": True, "off": False},
    {"inf": math.inf, "ninf": -math.inf, "nan": math.nan, "big": 1e300,
     "tiny": 1.234567890123e-12, "neg": -7},
    {},
]


@pytest.mark.parametrize("snap", SNAPSHOTS, ids=["mixed", "nonfinite",
                                                 "empty"])
@pytest.mark.parametrize("labels", [None, {"ds": "amzn", "b": "x"}])
def test_prometheus_text_matches_reference(snap, labels):
    assert prometheus_text(snap, labels=labels) == \
        rexport.prometheus_text(snap, labels=labels)
    assert prometheus_text(snap, prefix="p_") == \
        rexport.prometheus_text(snap, prefix="p_")


class _Metrics:
    def snapshot(self):
        return {"requests": 2, "lookups": 64, "p99_request_ms": 3.25,
                "cache_hit_rate": 1.0}

    def windowed(self, window_s):
        return {"n": 2, "window_s": float(window_s), "p99_ms": 3.0}


class _Fixed:
    """A provider whose every surface is a constant: both packages'
    exporters see the same snapshot."""

    def __init__(self):
        self.metrics = _Metrics()
        self.recorder = SpanRecorder()
        self.recorder.instant("admit", cat="admission", rid=0)
        self.health = type("H", (), {"snapshot": lambda s, w: {
            "disp_p99": 12.0, "drift_tv": 0.125}})()
        self.alerts = type("A", (), {"firing": lambda s: ["slo"]})()


def _no_clock(doc):
    return {k: v for k, v in doc.items() if k != "t_unix"}


def test_metrics_payload_and_render_match_reference():
    prov = _Fixed()
    got = metrics_payload(prov, window_s=60.0)
    want = rexport.metrics_payload(prov, window_s=60.0)
    assert _no_clock(got) == _no_clock(want)
    assert got["trace_spans"] == 1 and got["alerts_firing"] == ["slo"]
    with MetricsServer(prov, port=0) as srv:
        text = srv.render_prometheus(30.0)
    rsrv = rexport.MetricsServer(prov, port=0)
    try:
        assert text == rsrv.render_prometheus(30.0)
    finally:
        rsrv.close()
    assert "repro_lookup_window_p99_ms" in text
    assert "repro_lookup_health_drift_tv" in text


# ---------------------------------------------------------------------------
# the HTTP surface and the JSONL feed over a live port service
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def served():
    keys = sosd.generate("amzn", 20_000, seed=3)
    q = sosd.make_queries(keys, 2_048, seed=5)
    svc = LookupService(keys, LookupServiceConfig(
        index="pgm", hyper=dict(eps=32), max_batch=256, deadline_ms=1.0,
        executor="async", trace=True), device=CPU)
    svc.start()
    for f in [svc.submit(q[i:i + 64]) for i in range(0, q.size, 64)]:
        f.result(60.0)
    yield svc
    svc.stop()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as r:
        return r.status, r.read().decode()


def test_metrics_server_endpoints(served):
    with MetricsServer(served, port=0) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        status, text = _get(base, "/metrics")
        assert status == 200
        for name in ("repro_lookup_p99_request_ms",
                     "repro_lookup_window_p99_ms",
                     "repro_lookup_health_disp_p99",
                     "repro_lookup_cache_hit_rate"):
            assert name in text, name
        status, body = _get(base, "/metrics.json?window_s=120")
        doc = json.loads(body)
        assert status == 200 and doc["lifetime"]["lookups"] == 2_048
        assert doc["windowed"]["window_s"] == 120.0
        status, body = _get(base, "/trace.json")
        assert status == 200
        assert json.loads(body)["otherData"]["dropped_spans"] == 0
        status, body = _get(base, "/health.json")
        doc = json.loads(body)
        assert doc["snapshot"]["serving"] == 1.0
        assert doc["generations"] and "firing" in doc["alerts"]
        status, body = _get(base, "/alerts.json")
        assert status == 200 and "rules" in json.loads(body)
        status, body = _get(base, "/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"
        for path, code in (("/autotune.json", 404), ("/nope", 404),
                           ("/metrics?window_s=bad", 400)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(base, path)
            assert ei.value.code == code, path


def test_autotune_json_answers_200_with_a_retuner():
    """`/autotune.json` renders the retuner's document when the provider
    has one attached (the 404 above is a provider without one), the same
    document the reference's exporter renders from the same keys."""
    from repro_torch.autotune import AutotuneConfig

    keys = np.arange(1, 4_001, dtype=np.uint64) * 5
    svc = LookupService(keys, LookupServiceConfig(
        index="pgm", autotune=AutotuneConfig(calibrate=False)), device=CPU)
    with svc, MetricsServer(svc, port=0) as srv:
        status, body = _get(f"http://127.0.0.1:{srv.port}", "/autotune.json")
        assert status == 200
        doc = json.loads(body)
        assert doc["alive"] is False and doc["counters"]["polls"] == 0
        assert doc["config"]["triggers"] == ["workload_drift",
                                             "error_inflation", "slo_burn"]
        assert "t_unix" in doc and "store" not in doc
        ref_doc = json.loads(rexport.MetricsServer.render_autotune(
            type("P", (), {"provider": svc})()))
        ref_doc.pop("t_unix"), doc.pop("t_unix")
        assert ref_doc == doc


def test_metrics_server_trace_404_and_healthz_503_when_stopped():
    keys = np.arange(1, 2_001, dtype=np.uint64) * 3
    svc = LookupService(keys, LookupServiceConfig(executor="async"),
                        device=CPU)
    with MetricsServer(svc, port=0) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        for path, code in (("/trace.json", 404), ("/healthz", 503)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(base, path)
            assert ei.value.code == code, path


def test_jsonl_logger_appends_parseable_lines(tmp_path, served):
    path = str(tmp_path / "metrics.jsonl")
    logger = JsonlMetricsLogger(served, path, interval_s=60.0)
    assert logger.write_once() and logger.write_once()
    with open(path) as f:
        docs = [json.loads(ln) for ln in f]
    assert len(docs) == 2 == logger.n_written
    assert all(d["lifetime"]["lookups"] == 2_048 for d in docs)
    with JsonlMetricsLogger(served, path, interval_s=60.0):
        pass                        # start/stop writes the final snapshot
    with open(path) as f:
        assert len(f.readlines()) == 3
    bad = JsonlMetricsLogger(served, str(tmp_path / "no" / "dir.jsonl"))
    assert not bad.write_once() and bad.n_errors == 1


@pytest.mark.parametrize("executor", ["sync", "async"])
def test_traced_service_reconciles_p99_and_ids(executor):
    keys = sosd.generate("amzn", 30_000, seed=3)
    q = sosd.make_queries(keys, 3_200, seed=5)
    svc = LookupService(keys, LookupServiceConfig(
        index="rmi", hyper=dict(branching=512), max_batch=256,
        deadline_ms=1.0, executor=executor, trace=True, slo_p99_ms=5000.0),
        device=CPU)
    with svc:
        futs = [svc.submit(q[i:i + 64]) for i in range(0, len(q), 64)]
        for f in futs:
            f.result(timeout=60.0)
    trace = json.loads(json.dumps(svc.recorder.to_chrome()))
    lat = SpanRecorder.request_latencies_s(trace)
    assert len(lat) == len(futs)
    admits = {e["args"]["rid"] for e in trace["traceEvents"]
              if e.get("cat") == "admission" and e["ph"] == "i"}
    assert admits == set(lat)
    snap = svc.metrics.snapshot()
    trace_p99 = float(np.quantile(np.asarray(sorted(lat.values())), 0.99,
                                  method="higher"))
    h = svc.metrics.request_latency
    assert h.n == len(futs)
    assert abs(h.bucket_index(trace_p99)
               - h.bucket_index(snap["p99_request_ms"] / 1e3)) <= 1
    w = svc.metrics.windowed(window_s=svc.metrics.windows.max_window_s)
    assert w["lookups"] == len(q) and w["slo_violations"] == 0
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] != "M"}
    want = {"launch", "finalize", "warmup"} if executor == "async" \
        else {"pad_place", "device"}
    assert want <= names


# ---------------------------------------------------------------------------
# the stage profiler
# ---------------------------------------------------------------------------
FAMILIES = ["rmi", "pgm", "radix_spline", "btree", "ibtree", "rbs",
            "binary_search"]


def _builds(name):
    keys = rsosd.generate("face", 20_000, seed=1)
    hyper = dict(rspec.SCHEMAS[name].ladder[
        len(rspec.SCHEMAS[name].ladder) // 2])
    b = spec.build(spec.IndexSpec(name, dict(hyper)), keys, device=CPU)
    rb = rspec.build(rspec.IndexSpec(name, dict(hyper)), keys)
    return keys, b, rb


@pytest.mark.parametrize("name", FAMILIES)
def test_proxy_decomposition_matches_reference(name):
    keys, b, rb = _builds(name)
    q = rsosd.make_queries(keys, 2_000, seed=2)
    lo, hi = b.lookup(b.state, encode_keys(q, CPU))
    widths = np.maximum(hi.numpy() - lo.numpy() + 1, 1)
    got = profiler.proxy_decomposition(b, widths)
    want = rprofiler.proxy_decomposition(rb, widths)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-9), k
    assert 0.0 <= got["proxy_search_ns"] <= got["proxy_total_ns"]


@pytest.mark.parametrize("name,backend", [("rmi", "cuda"), ("rmi", "torch"),
                                          ("pgm", "cuda"),
                                          ("robin_hash", "torch")])
def test_profile_generation_on_the_cpu_has_the_reference_shape(name,
                                                               backend):
    from repro_torch.serve.lookup import IndexRegistry

    keys = sosd.generate("wiki", 20_000, seed=3)
    q = sosd.make_queries(keys, 4_096, seed=4)
    gen = IndexRegistry(device=CPU).build_and_publish(
        spec.IndexSpec(name, backend=backend), keys)
    row = profiler.profile_generation(gen, q, repeats=2)
    assert row["index"] == name and row["backend"] == backend
    assert row["n_queries"] == 4_096
    assert row["stage_total_ns"] > 0.0
    assert 0.0 <= row["stage_predict_ns"] <= row["stage_total_ns"]
    assert row["stage_search_ns"] == pytest.approx(
        row["stage_total_ns"] - row["stage_predict_ns"])
    if name == "robin_hash":
        assert row["stage_search_ns"] == 0.0 and "proxy_total_ns" not in row
    else:
        assert row["cost_model_ratio"] == pytest.approx(
            row["stage_total_ns"] / row["proxy_total_ns"])
    assert set(row) <= {"backend", "n_queries", "stage_predict_ns",
                        "stage_search_ns", "stage_total_ns",
                        "stage_predict_frac", "index", "proxy_predict_ns",
                        "proxy_search_ns", "proxy_total_ns", "avg_width",
                        "cost_model_ratio"}


def test_time_fn_s_is_best_of_k_on_the_host_clock():
    calls = []
    t = profiler.time_fn_s(lambda x: calls.append(x), 1, repeats=3)
    assert calls == [1, 1, 1, 1] and t >= 0.0
    keys = sosd.generate("osm", 5_000, seed=1)
    p = plan_mod.lower(spec.build(spec.IndexSpec("pgm"), keys, device=CPU),
                       encode_keys(keys, CPU))
    assert profiler.time_fn_s(p.compile("torch"),
                              encode_keys(keys[:100], CPU)) > 0.0
