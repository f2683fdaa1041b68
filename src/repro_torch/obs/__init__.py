"""`repro_torch.obs`: the observability layer of the port's services.

Stdlib and numpy copies of the reference's `repro.obs` pieces that the
lookup service uses, each importable without the serve stack (the serve
stack imports *us*):

  windows    log-spaced `LatencyHistogram` and `WindowedMetrics`, a ring
             of per-time-slot sub-histograms merged at read, with SLO
             tracking (p99 target, error-budget burn rate).
  trace      `SpanRecorder`, a bounded-ring structured span recorder with
             per-request ids, exported as Chrome-trace JSON; the guards
             that put spans into code, each mirrored onto a running
             `torch.profiler` as a `record_function` range: `maybe_span`
             (the service's sites, which hold their recorder) and `span`
             (the index's set-up and read path, which record into the
             current recorder that `recording` installs).
  health     per-generation model health: prediction-displacement
             statistics against the static ``max_err`` bound and a
             windowed rank-traffic drift score, fed by the device-reduced
             stats of `core.plan.instrumented_expr`.
  alerts     declarative `AlertRule` thresholds over a flat snapshot,
             evaluated by an `AlertEngine` with ok/firing/resolved state.
  profiler   per-plan-stage timing: predict vs bounded search per
             (index, backend), CUDA events on the card, against the
             `analysis.cost_ns` proxy.
  export     Prometheus-text + JSON exporters, a stdlib HTTP metrics
             endpoint (`MetricsServer`) and periodic JSONL logging
             (`JsonlMetricsLogger`).
"""
from repro_torch.obs.alerts import (AlertEngine, AlertRule, JsonlSink,
                                    LogSink, default_rules)
from repro_torch.obs.health import GenerationHealth, HealthMonitor
from repro_torch.obs.trace import SpanRecorder, maybe_span, recording, span
from repro_torch.obs.windows import LatencyHistogram, WindowedMetrics

__all__ = [
    "AlertEngine",
    "AlertRule",
    "GenerationHealth",
    "HealthMonitor",
    "JsonlSink",
    "LatencyHistogram",
    "LogSink",
    "SpanRecorder",
    "WindowedMetrics",
    "default_rules",
    "maybe_span",
    "recording",
    "span",
]
