"""Structured span recorder with Chrome-trace export, and the port's one
span API.

`SpanRecorder` is the request-causality half of the observability layer:
a bounded ring buffer of spans stamped on the serve path's shared clock
(`time.perf_counter`, the same clock `PendingRequest.t_submit` uses, so
admission timestamps and completion timestamps subtract exactly).  The
recording cost is one lock + one deque append.

Two guards put spans into the code, and both mirror each span onto the
profiler's clock: while `torch.profiler` runs
(``torch.autograd._profiler_enabled()``), a span also opens a
`torch.profiler.record_function` range of its name, so a device trace
puts each kernel under the port span that launched it.

  maybe_span(recorder, ...)   the service's sites, which hold their
                              recorder (``None`` when tracing is off)
  span(name, **args)          the index's own sites (set-up and read
                              path), which record into the *current*
                              recorder: the one `recording(recorder)`
                              installs in this thread's context
                              (a `contextvars` variable), if any

With no recorder and no profiler either guard returns one shared
`contextlib.nullcontext` after those two checks; torch is looked up only
once it has been imported, so this module stays importable (and
stdlib-only) without the serve stack.

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
  index       the index's own spans (`span`): set-up ``index.fit``
              (``fit.host``, ``fit.verify``), ``index.lower``,
              ``index.compile`` (RMI's ``refit.stage1``, ``refit.bins``,
              ``refit.verify``); the read path ``lookup`` (one a call of
              a `LookupPlan.compile` callable), ``lookup.predict``,
              PGM's ``pgm.top``, ``pgm.level{k}``, ``pgm.leaf`` (its
              torch descent, `core.pgm.descend`; the fused
              ``pgm_lookup`` kernel on the card shows none),
              RadixSpline's ``rs.radix``, ``rs.knots``, ``rs.interp``
              (`core.radix_spline.predict`), ``lookup.search`` and
              ``kernel.launch`` (the ctypes call)

Export is the Chrome trace-event JSON format ("traceEvents" with "X"
complete events, µs timestamps), openable in `chrome://tracing` or
Perfetto: a slow request shows as a long `request` span visually
overlapping whatever caused it — a deep queue, a `compile` span, or a
`compaction` span on the compactor thread.  The ring bound is explicit:
`to_chrome` reports how many spans were dropped, never silently
truncates.

The recorder is a copy of the reference's `repro.obs.trace`, held equal
to it by `tests/test_torch_obs.py`; the profiler mirror, `span` and
`recording` are the port's own.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import json
import sys
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Span", "SpanRecorder", "maybe_span", "recording", "span"]

#: the recorder `span` writes to in this context (`recording` sets it)
_CURRENT: "contextvars.ContextVar[Optional[SpanRecorder]]" = \
    contextvars.ContextVar("repro_torch_span_recorder", default=None)
#: what every guard returns when nothing records
_NULL = contextlib.nullcontext()
#: ``torch.autograd._profiler_enabled``, once torch has been imported
_profiler_enabled = None


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


def _profiling() -> bool:
    """Whether a `torch.profiler` session is recording on this thread;
    False while torch has not been imported, since then none can be."""
    global _profiler_enabled
    if _profiler_enabled is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return False
        _profiler_enabled = torch.autograd._profiler_enabled
    return _profiler_enabled()


class _Traced:
    """The span in ``recorder`` (if any) and, when ``profiling``, a
    `record_function` range of the same name inside it."""

    __slots__ = ("recorder", "name", "cat", "args", "fn", "t0")

    def __init__(self, recorder: Optional["SpanRecorder"], name: str,
                 cat: str, profiling: bool, args: dict):
        self.recorder, self.name, self.cat, self.args = (recorder, name,
                                                         cat, args)
        self.fn = sys.modules["torch"].profiler.record_function(name) \
            if profiling else None

    def __enter__(self):
        self.t0 = time.perf_counter()
        if self.fn is not None:
            self.fn.__enter__()
        return self

    def __exit__(self, *exc):
        if self.fn is not None:
            self.fn.__exit__(*exc)
        if self.recorder is not None:
            self.recorder.add(self.name, self.t0, time.perf_counter(),
                              cat=self.cat, **self.args)
        return False


def maybe_span(recorder: Optional["SpanRecorder"], name: str,
               cat: str = "serve", **args):
    """Context manager recording a span when tracing is on, a no-op
    otherwise — the guard the service's instrumentation sites use.  Under
    a running profiler the span is also a `record_function` range."""
    profiling = _profiling()
    if recorder is None and not profiling:
        return _NULL
    return _Traced(recorder, name, cat, profiling, args)


@contextlib.contextmanager
def recording(recorder: Optional["SpanRecorder"]):
    """Make ``recorder`` the current recorder of this context (this
    thread, or this task) for the ``with`` block; ``None`` turns the
    index's spans off inside it."""
    token = _CURRENT.set(recorder)
    try:
        yield recorder
    finally:
        _CURRENT.reset(token)


def span(name: str, cat: str = "index", **args):
    """A span of the index's own code: recorded into the current
    recorder and mirrored onto a running profiler; with neither, the one
    shared no-op after two checks."""
    recorder = _CURRENT.get()
    profiling = _profiling()
    if recorder is None and not profiling:
        return _NULL
    return _Traced(recorder, name, cat, profiling, args)


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
