"""Structured span recorder with Chrome-trace export.

`SpanRecorder` is the request-causality half of the observability layer:
a bounded ring buffer of spans stamped on the serve path's shared clock
(`time.perf_counter`, the same clock `PendingRequest.t_submit` uses, so
admission timestamps and completion timestamps subtract exactly).  The
recording cost is one lock + one deque append; when tracing is disabled
the serve path holds ``None`` and skips even that (`maybe_span`).

Span taxonomy (the ``cat`` field):

  admission   instants at `MicroBatcher.submit` (one per request id) and
              backlog/rate rejections
  request     one complete span per finished request: admission ->
              futures resolved, args carry rid / kind / n_keys and the
              queue vs execute decomposition
  serve       dispatch-side phases: launch, device wait ("finalize"),
              pad+place
  compile     executable-cache builds (misses and warm-up compiles) —
              the p99 outliers the async executor exists to hide
  lifecycle   index_build/publish (hot-swap), warmup, compaction

Export is the Chrome trace-event JSON format ("traceEvents" with "X"
complete events, µs timestamps), openable in `chrome://tracing` or
Perfetto: a slow request shows as a long `request` span visually
overlapping whatever caused it — a deep queue, a `compile` span, or a
`compaction` span on the compactor thread.  The ring bound is explicit:
`to_chrome` reports how many spans were dropped, never silently
truncates.

Stdlib only: a copy of the reference's `repro.obs.trace`, held equal to
it by `tests/test_torch_obs.py`.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Span", "SpanRecorder", "maybe_span"]


@dataclasses.dataclass(frozen=True)
class Span:
    """One recorded event; ``t0``/``dur`` in perf_counter seconds."""

    name: str
    cat: str
    t0: float
    dur: float              # 0.0 for instants
    tid: int
    ph: str = "X"           # "X" complete | "i" instant
    args: Optional[Dict] = None


def maybe_span(recorder: Optional["SpanRecorder"], name: str,
               cat: str = "serve", **args):
    """Context manager recording a span when tracing is on, a no-op
    otherwise — the one guard every instrumentation site uses."""
    if recorder is None:
        return contextlib.nullcontext()
    return recorder.span(name, cat=cat, **args)


class SpanRecorder:
    """Thread-safe bounded ring of spans; overflow drops the oldest."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.t_epoch = time.perf_counter()   # exported ts are relative
        self._mu = threading.Lock()
        self._spans: "collections.deque[Span]" = collections.deque(
            maxlen=self.capacity)
        self._thread_names: Dict[int, str] = {}
        self.n_recorded = 0                  # total, including dropped

    # -- recording -------------------------------------------------------
    def _tid(self) -> int:
        th = threading.current_thread()
        ident = th.ident or 0
        if ident not in self._thread_names:
            with self._mu:
                self._thread_names.setdefault(ident, th.name)
        return ident

    def add(self, name: str, t0: float, t1: float, cat: str = "serve",
            ph: str = "X", tid: Optional[int] = None, **args) -> None:
        span = Span(name=name, cat=cat, t0=t0, dur=max(0.0, t1 - t0),
                    tid=self._tid() if tid is None else tid, ph=ph,
                    args=args or None)
        with self._mu:
            self._spans.append(span)
            self.n_recorded += 1

    def instant(self, name: str, cat: str = "serve",
                t: Optional[float] = None, **args) -> None:
        t = time.perf_counter() if t is None else t
        self.add(name, t, t, cat=cat, ph="i", **args)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "serve", **args):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter(), cat=cat, **args)

    def request(self, rid: int, *, kind: str, n_keys: int,
                t_submit: float, t_launch: float, t_end: float) -> None:
        """The per-request span: admission -> future resolved, with the
        queue/execute decomposition inline (queue + execute == the span's
        whole duration)."""
        self.add("request", t_submit, t_end, cat="request",
                 rid=int(rid), kind=kind, n_keys=int(n_keys),
                 queue_us=round((t_launch - t_submit) * 1e6, 3),
                 exec_us=round((t_end - t_launch) * 1e6, 3))

    # -- reading ---------------------------------------------------------
    def spans(self) -> List[Span]:
        with self._mu:
            return list(self._spans)

    @property
    def n_dropped(self) -> int:
        with self._mu:
            return self.n_recorded - len(self._spans)

    def __len__(self) -> int:
        with self._mu:
            return len(self._spans)

    # -- chrome-trace export ---------------------------------------------
    def to_chrome(self) -> Dict:
        """The trace as a Chrome trace-event JSON object (µs timestamps
        relative to the recorder's epoch), with thread-name metadata and
        an explicit dropped-span count."""
        with self._mu:
            spans = list(self._spans)
            names = dict(self._thread_names)
            dropped = self.n_recorded - len(spans)
        events = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                   "args": {"name": name}} for tid, name in sorted(names.items())]
        for s in spans:
            ev = {"name": s.name, "cat": s.cat, "ph": s.ph, "pid": 0,
                  "tid": s.tid,
                  "ts": round((s.t0 - self.t_epoch) * 1e6, 3)}
            if s.ph == "X":
                ev["dur"] = round(s.dur * 1e6, 3)
            if s.ph == "i":
                ev["s"] = "t"     # instant scope: thread
            if s.args:
                ev["args"] = s.args
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": dropped,
                              "recorded_spans": self.n_recorded}}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path

    # -- parse-side helpers (reconciliation + tests) ----------------------
    @staticmethod
    def request_events(trace: Dict) -> List[Dict]:
        """The per-request "X" spans of an exported (or re-parsed) trace."""
        return [ev for ev in trace.get("traceEvents", ())
                if ev.get("ph") == "X" and ev.get("cat") == "request"]

    @staticmethod
    def request_latencies_s(trace: Dict) -> Dict[int, float]:
        """rid -> end-to-end request latency (seconds), parsed back from
        the µs export — the trace side of the trace-vs-histogram p99
        reconciliation."""
        out: Dict[int, float] = {}
        for ev in SpanRecorder.request_events(trace):
            args = ev.get("args") or {}
            if "rid" in args:
                out[int(args["rid"])] = float(ev.get("dur", 0.0)) / 1e6
        return out
