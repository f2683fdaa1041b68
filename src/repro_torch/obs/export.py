"""Ops export surface: Prometheus text, JSON, HTTP, JSONL.

A copy of the reference's `repro.obs.export` (stdlib only).

Everything here is stdlib-only and pull-based, wrapped around whatever
object exposes the serve-path metrics contract:

  provider.metrics.snapshot()            lifetime aggregate dict
  provider.metrics.windowed(window_s)    rolling-window dict (optional)
  provider.recorder                      `SpanRecorder` or None

which is exactly what `LookupService` / `MutableLookupService` look
like.  Surfaces:

  prometheus_text   one gauge line per numeric snapshot key (the
                    Prometheus text exposition format a scraper ingests)
  MetricsServer     stdlib ThreadingHTTPServer on a daemon thread:
                    /metrics (Prometheus text: lifetime + windowed +
                    index health), /metrics.json (structured),
                    /trace.json (Chrome trace when tracing is on),
                    /health.json (flat health snapshot + per-generation
                    records + alert states), /alerts.json (the full
                    alert-engine document, evaluated at request time),
                    /autotune.json (the shadow retuner's config,
                    counters, and decision history when one is attached;
                    404 without one),
                    /healthz (200/503 from the provider's
                    `health_status` when it has one — stopped service
                    or firing critical alert answers 503)
  JsonlMetricsLogger  periodic snapshot appends to a JSONL file — the
                    offline-analysis feed (one timestamped JSON object
                    per line; pandas/jq-friendly).  A failed write
                    (disk full, path removed) counts in ``n_errors``
                    and the loop keeps going.
"""
from __future__ import annotations

import http.server
import json
import math
import threading
import time
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

__all__ = ["JsonlMetricsLogger", "MetricsServer", "metrics_payload",
           "prometheus_text"]


def _numeric(v) -> bool:
    return isinstance(v, (int, float, bool))


def _prom_value(v: float) -> str:
    """Prometheus exposition rendering of one sample value: the text
    format spells non-finite values ``+Inf``/``-Inf``/``NaN`` — bare
    ``inf``/``nan`` (Python's float repr) is a parse error upstream."""
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return f"{v:.10g}"


def prometheus_text(snapshot: Dict, prefix: str = "repro_lookup_",
                    labels: Optional[Dict[str, str]] = None) -> str:
    """Render one flat snapshot dict as Prometheus gauges.  Non-numeric
    values are skipped; ``labels`` are attached to every sample."""
    lbl = ""
    if labels:
        lbl = "{" + ",".join(
            f'{k}="{str(v)}"' for k, v in sorted(labels.items())) + "}"
    lines = []
    for key in sorted(snapshot):
        v = snapshot[key]
        if not _numeric(v):
            continue
        name = prefix + key
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{lbl} {_prom_value(float(v))}")
    return "\n".join(lines) + "\n"


def metrics_payload(provider, window_s: float = 10.0) -> Dict:
    """The structured metrics document every exporter serves: lifetime
    snapshot + rolling-window snapshot (when the metrics object has
    one), stamped with wall time."""
    payload: Dict = {"t_unix": time.time()}
    metrics = getattr(provider, "metrics", provider)
    payload["lifetime"] = metrics.snapshot()
    windowed = getattr(metrics, "windowed", None)
    if windowed is not None:
        payload["windowed"] = windowed(window_s)
    per_shard = getattr(metrics, "per_shard", None)
    if per_shard is not None:
        rows = per_shard()
        if rows:
            payload["per_shard"] = rows
    rec = getattr(provider, "recorder", None)
    if rec is not None:
        payload["trace_spans"] = len(rec)
        payload["trace_dropped"] = rec.n_dropped
    health = getattr(provider, "health", None)
    if health is not None:
        payload["health"] = health.snapshot(window_s)
    alerts = getattr(provider, "alerts", None)
    if alerts is not None:
        payload["alerts_firing"] = alerts.firing()
    return payload


class MetricsServer:
    """Stdlib HTTP metrics endpoint on a daemon thread.

    ``port=0`` binds an ephemeral port (tests); `port` reports the bound
    one.  The handler reads the provider's metrics at request time —
    scrapes always see current state, nothing is pushed or buffered.
    """

    def __init__(self, provider, port: int = 0, host: str = "127.0.0.1",
                 window_s: float = 10.0):
        self.provider = provider
        self.window_s = float(window_s)
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):   # noqa: D102 — keep scrapes quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):   # noqa: N802 — http.server API
                url = urlparse(self.path)
                try:
                    q = parse_qs(url.query)
                    try:
                        window_s = float(
                            q.get("window_s", [outer.window_s])[0])
                    except (TypeError, ValueError):
                        # a malformed query is the CLIENT's error: 400,
                        # not a 500 through the blanket handler below
                        self._send(400, b"bad window_s\n", "text/plain")
                        return
                    if url.path == "/metrics":
                        body = outer.render_prometheus(window_s)
                        self._send(200, body.encode(),
                                   "text/plain; version=0.0.4")
                    elif url.path == "/metrics.json":
                        body = json.dumps(
                            metrics_payload(outer.provider, window_s))
                        self._send(200, body.encode(), "application/json")
                    elif url.path == "/trace.json":
                        rec = getattr(outer.provider, "recorder", None)
                        if rec is None:
                            self._send(404, b"tracing disabled\n",
                                       "text/plain")
                        else:
                            self._send(200,
                                       json.dumps(rec.to_chrome()).encode(),
                                       "application/json")
                    elif url.path == "/health.json":
                        body = outer.render_health(window_s)
                        if body is None:
                            self._send(404, b"no health surface\n",
                                       "text/plain")
                        else:
                            self._send(200, body.encode(),
                                       "application/json")
                    elif url.path == "/alerts.json":
                        body = outer.render_alerts(window_s)
                        if body is None:
                            self._send(404, b"no alert engine\n",
                                       "text/plain")
                        else:
                            self._send(200, body.encode(),
                                       "application/json")
                    elif url.path == "/autotune.json":
                        body = outer.render_autotune()
                        if body is None:
                            self._send(404, b"no autotune\n",
                                       "text/plain")
                        else:
                            self._send(200, body.encode(),
                                       "application/json")
                    elif url.path == "/healthz":
                        status_fn = getattr(outer.provider,
                                            "health_status", None)
                        if status_fn is None:
                            self._send(200, b"ok\n", "text/plain")
                        else:
                            code, doc = status_fn(window_s)
                            self._send(code,
                                       (json.dumps(doc) + "\n").encode(),
                                       "application/json")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as e:   # noqa: BLE001 — a bad scrape must
                    # never take the serving process down with it
                    self._send(500, f"{e!r}\n".encode(), "text/plain")

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    def render_prometheus(self, window_s: Optional[float] = None) -> str:
        window_s = self.window_s if window_s is None else window_s
        payload = metrics_payload(self.provider, window_s)
        text = prometheus_text(payload["lifetime"])
        if "windowed" in payload:
            text += prometheus_text(payload["windowed"],
                                    prefix="repro_lookup_window_")
        if "health" in payload:
            text += prometheus_text(payload["health"],
                                    prefix="repro_lookup_health_")
        for row in payload.get("per_shard", []):
            text += prometheus_text(
                {k: v for k, v in row.items() if k != "shard"},
                prefix="repro_lookup_shard_",
                labels={"shard": str(row["shard"])})
        return text

    def render_health(self, window_s: Optional[float] = None):
        """The `/health.json` document, or None when the provider has no
        health surface: the flat alert-namespace snapshot, the per-
        generation records, and the alert states."""
        snap_fn = getattr(self.provider, "health_snapshot", None)
        if snap_fn is None:
            return None
        window_s = self.window_s if window_s is None else window_s
        doc: Dict = {"t_unix": time.time(),
                     "snapshot": snap_fn(window_s)}
        registry = getattr(self.provider, "registry", None)
        if registry is not None and hasattr(registry, "health_records"):
            doc["generations"] = registry.health_records(window_s)
        alerts = getattr(self.provider, "alerts", None)
        if alerts is not None:
            doc["alerts"] = {"firing": alerts.firing(),
                             "states": alerts.state()}
        return json.dumps(doc)

    def render_autotune(self):
        """The `/autotune.json` document (retuner state machine: config,
        counters, decision history, artifact-store stats), or None when
        the provider has no retuner attached."""
        at = getattr(self.provider, "autotune", None)
        if at is None:
            return None
        doc = at.to_dict()
        doc["t_unix"] = time.time()
        return json.dumps(doc)

    def render_alerts(self, window_s: Optional[float] = None):
        """The `/alerts.json` document, or None without an engine —
        rules are re-evaluated against a fresh snapshot first, so the
        reported states reflect request time, not the last poll."""
        alerts = getattr(self.provider, "alerts", None)
        if alerts is None:
            return None
        window_s = self.window_s if window_s is None else window_s
        check = getattr(self.provider, "check_alerts", None)
        if check is not None:
            check(window_s)
        doc = alerts.to_dict()
        doc["t_unix"] = time.time()
        return json.dumps(doc)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "MetricsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="metrics-http",
                daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join()
            self._thread = None
        self._httpd.server_close()

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


class JsonlMetricsLogger:
    """Append one metrics payload per interval to a JSONL file."""

    def __init__(self, provider, path: str, interval_s: float = 1.0,
                 window_s: float = 10.0):
        self.provider = provider
        self.path = path
        self.interval_s = float(interval_s)
        self.window_s = float(window_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.n_written = 0
        #: writes that failed (disk full, path removed, provider error).
        #: The loop keeps going — a logging outage must never silently
        #: kill the feed for the rest of the run.
        self.n_errors = 0

    def write_once(self) -> bool:
        """One snapshot append; returns whether it succeeded.  Failures
        count in ``n_errors`` instead of raising — the periodic loop
        (and any direct caller) survives a transient sink outage."""
        try:
            line = json.dumps(
                metrics_payload(self.provider, self.window_s))
            with open(self.path, "a") as f:
                f.write(line + "\n")
        except Exception:   # noqa: BLE001 — the feed outlives its sink
            self.n_errors += 1
            return False
        self.n_written += 1
        return True

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.write_once()
        self.write_once()   # final snapshot on stop: the run's end state

    def start(self) -> "JsonlMetricsLogger":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="metrics-jsonl", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "JsonlMetricsLogger":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
