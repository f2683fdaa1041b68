"""Declarative alert engine over flat metric snapshots.

An `AlertRule` is one threshold over one key of a flat snapshot dict —
the namespace `LookupService.health_snapshot()` produces (lifetime
metrics + ``window_``-prefixed rolling window + generation health).
The `AlertEngine` evaluates every rule against a snapshot (pull-based:
callers decide when — the HTTP endpoints, the serve driver's doctor
report, the benchmarks' health cells), tracks ok/firing/resolved state
per rule, and emits fire/resolve events to pluggable sinks.

State vs emission are deliberately separate: a rule's STATE always
tracks the truth (so ``/healthz`` never lies about a firing critical
alert), while cooldown only suppresses repeated sink EMISSION of a
flapping rule.  A fire suppressed by cooldown is emitted late if the
rule is still firing once the cooldown expires, and cancelled silently
if it resolved first — operators see one notification per sustained
incident, not one per flap.

``min_samples`` gates guard cold starts: a drift score over 40 lookups
or a cache-hit rate over 2 accesses is noise, not an incident.

Stdlib only: a copy of the reference's `repro.obs.alerts` (the same
rules, thresholds and state machine), held equal to it by
`tests/test_torch_obs.py`.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import logging
import operator
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["AlertEngine", "AlertRule", "JsonlSink", "LogSink",
           "default_rules"]

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": operator.gt, ">=": operator.ge,
    "<": operator.lt, "<=": operator.le,
    "==": operator.eq, "!=": operator.ne,
}

SEVERITIES = ("warning", "critical")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative threshold: ``snapshot[key] <op> threshold``."""

    name: str
    key: str
    op: str = ">"
    threshold: float = 0.0
    severity: str = "warning"
    cooldown_s: float = 30.0
    #: Gate: the rule only evaluates once ``snapshot[min_samples_key]``
    #: reaches ``min_samples`` (None = always evaluate).
    min_samples_key: Optional[str] = None
    min_samples: float = 0.0
    description: str = ""
    action: str = ""           # the runbook line: what an operator does

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown op {self.op!r}; one of {list(_OPS)}")
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {self.severity!r}")

    def check(self, snapshot: Dict) -> Optional[Tuple[bool, float]]:
        """``(breached, value)``, or None when the key is absent or the
        sample gate is not met (the rule abstains — state unchanged)."""
        v = snapshot.get(self.key)
        if v is None or not isinstance(v, (int, float, bool)):
            return None
        if self.min_samples_key is not None:
            ns = snapshot.get(self.min_samples_key, 0.0)
            if float(ns) < self.min_samples:
                return None
        return _OPS[self.op](float(v), float(self.threshold)), float(v)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


class _RuleState:
    __slots__ = ("state", "last_value", "t_changed", "t_last_fire_emit",
                 "pending_emit", "n_fired", "n_resolved", "n_suppressed")

    def __init__(self):
        self.state = "ok"                # "ok" | "firing" | "resolved"
        self.last_value: Optional[float] = None
        self.t_changed: Optional[float] = None
        self.t_last_fire_emit: Optional[float] = None
        self.pending_emit = False        # fire suppressed, not yet emitted
        self.n_fired = 0
        self.n_resolved = 0
        self.n_suppressed = 0

    def to_dict(self) -> Dict:
        return {"state": self.state, "last_value": self.last_value,
                "t_changed": self.t_changed, "n_fired": self.n_fired,
                "n_resolved": self.n_resolved,
                "n_suppressed": self.n_suppressed}


class LogSink:
    """Emit events through stdlib logging (warning/critical by severity)."""

    def __init__(self, logger: Optional[logging.Logger] = None):
        self.logger = logger or logging.getLogger("repro_torch.obs.alerts")

    def __call__(self, event: Dict) -> None:
        level = (logging.CRITICAL if event["severity"] == "critical"
                 else logging.WARNING)
        self.logger.log(
            level, "alert %s %s: %s=%s (threshold %s %s)",
            event["rule"], event["state"], event["key"], event["value"],
            event["op"], event["threshold"])


class JsonlSink:
    """Append one JSON object per event to a file (offline alert feed)."""

    def __init__(self, path: str):
        self.path = path

    def __call__(self, event: Dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(event) + "\n")


class AlertEngine:
    """Evaluate rules over snapshots; track state; emit to sinks.

    Sink failures are isolated PER (event, sink) call: one sink raising
    on one rule's event never blocks another rule's delivery or the
    evaluation itself — failures are counted in ``n_sink_errors``.
    """

    def __init__(self, rules: Sequence[AlertRule] = (),
                 sinks: Sequence[Callable[[Dict], None]] = (),
                 clock=time.perf_counter, history: int = 256):
        self._mu = threading.Lock()
        self._clock = clock
        self.rules: List[AlertRule] = list(rules)
        self.sinks: List[Callable[[Dict], None]] = list(sinks)
        self._states: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules}
        self.events: "collections.deque" = collections.deque(maxlen=history)
        self.n_evaluations = 0
        self.n_sink_errors = 0

    def add_rule(self, rule: AlertRule) -> None:
        with self._mu:
            self.rules.append(rule)
            self._states[rule.name] = _RuleState()

    def add_sink(self, sink: Callable[[Dict], None]) -> None:
        with self._mu:
            self.sinks.append(sink)

    # -- evaluation -------------------------------------------------------
    def evaluate(self, snapshot: Dict,
                 t: Optional[float] = None) -> List[Dict]:
        """One pass over every rule; returns the emitted events."""
        t = self._clock() if t is None else t
        emitted: List[Dict] = []
        with self._mu:
            self.n_evaluations += 1
            for rule in self.rules:
                st = self._states[rule.name]
                res = rule.check(snapshot)
                if res is None:
                    continue
                breached, value = res
                st.last_value = value
                cooled = (st.t_last_fire_emit is None
                          or t - st.t_last_fire_emit >= rule.cooldown_s)
                if breached and st.state != "firing":
                    st.state = "firing"
                    st.n_fired += 1
                    st.t_changed = t
                    if cooled:
                        st.t_last_fire_emit = t
                        emitted.append(self._event(rule, st, "firing",
                                                   value, t))
                    else:
                        st.n_suppressed += 1
                        st.pending_emit = True
                elif breached and st.pending_emit and cooled:
                    # still firing when the cooldown expired: late-emit
                    # the one notification the flap suppressed
                    st.pending_emit = False
                    st.t_last_fire_emit = t
                    emitted.append(self._event(rule, st, "firing",
                                               value, t))
                elif not breached and st.state == "firing":
                    st.state = "resolved"
                    st.n_resolved += 1
                    st.t_changed = t
                    if st.pending_emit:
                        # the fire was never delivered — cancel silently
                        st.pending_emit = False
                    else:
                        emitted.append(self._event(rule, st, "resolved",
                                                   value, t))
            self.events.extend(emitted)
            sinks = list(self.sinks)
        for event in emitted:
            for sink in sinks:
                try:
                    sink(event)
                except Exception:   # noqa: BLE001 — isolate per (event, sink)
                    with self._mu:
                        self.n_sink_errors += 1
        return emitted

    @staticmethod
    def _event(rule: AlertRule, st: _RuleState, state: str,
               value: float, t: float) -> Dict:
        return {"rule": rule.name, "key": rule.key, "op": rule.op,
                "threshold": rule.threshold, "severity": rule.severity,
                "state": state, "value": value, "t": t,
                "n_fired": st.n_fired,
                "description": rule.description, "action": rule.action}

    # -- reads ------------------------------------------------------------
    def firing(self, severity: Optional[str] = None) -> List[str]:
        """Names of rules currently in the firing state."""
        with self._mu:
            sev = {r.name: r.severity for r in self.rules}
            return [name for name, st in self._states.items()
                    if st.state == "firing"
                    and (severity is None or sev.get(name) == severity)]

    def has_critical_firing(self) -> bool:
        return bool(self.firing(severity="critical"))

    def firing_since(self) -> Dict[str, float]:
        """``{rule_name: t_changed}`` for rules currently firing — the
        hysteresis input consumers like the autotune retuner use to act
        only on alerts that have been CONTINUOUSLY firing for a dwell
        period, not on one-sample flaps."""
        with self._mu:
            return {name: float(st.t_changed)
                    for name, st in self._states.items()
                    if st.state == "firing" and st.t_changed is not None}

    def state(self) -> Dict[str, Dict]:
        with self._mu:
            return {name: st.to_dict()
                    for name, st in self._states.items()}

    def to_dict(self) -> Dict:
        with self._mu:
            return {
                "rules": [r.to_dict() for r in self.rules],
                "states": {n: s.to_dict() for n, s in self._states.items()},
                "firing": [n for n, s in self._states.items()
                           if s.state == "firing"],
                "events": list(self.events),
                "n_evaluations": self.n_evaluations,
                "n_sink_errors": self.n_sink_errors,
            }


def default_rules() -> Tuple[AlertRule, ...]:
    """The shipped ruleset over `LookupService.health_snapshot()` keys —
    thresholds documented (with operator actions) in the README runbook.
    Sample gates keep every rule quiet on cold starts and tiny tests."""
    return (
        AlertRule(
            "slo_burn", key="window_slo_budget_burn", op=">",
            threshold=2.0, severity="critical", cooldown_s=30.0,
            min_samples_key="window_n", min_samples=32,
            description="p99 SLO error budget burning > 2x the "
                        "sustainable rate over the trailing window",
            action="inspect window_p99_ms vs p99_batch_ms/p99_queue_ms "
                   "split; raise max_batch/slots or scale out"),
        AlertRule(
            "workload_drift", key="drift_tv", op=">", threshold=0.6,
            cooldown_s=30.0,
            min_samples_key="drift_n", min_samples=512,
            description="windowed key-space traffic diverged from the "
                        "build-time key distribution: more than 60% of "
                        "the traffic mass moved (total variation; "
                        "stationary mixed-hit/miss traffic measures "
                        "<= ~0.5, a hot-spot shift ~0.98)",
            action="retune/rebuild against live traffic (swap_keys or "
                   "compaction with a Tuner); verify upstream routing"),
        AlertRule(
            "error_inflation", key="disp_p99_ratio", op=">",
            threshold=2.0, cooldown_s=30.0,
            min_samples_key="health_n", min_samples=512,
            description="live p99 prediction displacement exceeds 2x "
                        "the build-time level of the same model — "
                        "prediction error is inflating toward the "
                        "static max_err bound (the raw "
                        "bound_utilization_p99 gauge saturates near "
                        "1.0 even when healthy for eps-bounded "
                        "indexes, so the rule keys on the "
                        "build-relative ratio; stationary traffic "
                        "measures ~1.0)",
            action="rebuild with a larger error budget (eps/branching) "
                   "or retune against live keys before bound "
                   "violations surface as wrong windows"),
        AlertRule(
            "cache_hit_collapse", key="cache_hit_rate", op="<",
            threshold=0.5, cooldown_s=30.0,
            min_samples_key="cache_accesses", min_samples=32,
            description="executable-cache hit rate collapsed under "
                        "serving traffic (per-batch recompiles)",
            action="check warm_buckets cover the traffic's batch sizes; "
                   "look for generation churn (compaction storm)"),
        AlertRule(
            "slot_saturation", key="inflight_saturation", op=">=",
            threshold=0.98, cooldown_s=30.0,
            min_samples_key="batches", min_samples=128,
            description="async in-flight slot ring persistently full — "
                        "dispatch is backpressured on completion",
            action="raise slots, raise max_batch, or shed load; check "
                   "for a straggler bucket occupying slots"),
        AlertRule(
            "trace_drops", key="trace_dropped", op=">", threshold=0.0,
            cooldown_s=30.0,
            description="span recorder dropped spans (ring capacity "
                        "exceeded) — the trace under-reports",
            action="raise trace_capacity or disable tracing under "
                   "sustained load"),
    )
