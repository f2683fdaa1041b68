"""Index generations with atomic hot-swap.

A `Generation` is one fully-built, immutable serving unit: the
`IndexBuild`, the device copy of the sorted keys (encoded), the
`LookupPlan` the build lowers to, and the plan-compiled lookup for the
generation's backend.  The registry's only mutable cell is a name ->
Generation pointer; `publish` replaces that pointer AFTER the build
completes, so a reader observes the old generation or the new one, never
a half-built one.  Swapping does not drain in-flight batches: a
dispatched batch pins the generation it was taken with and completes
against it even if a swap lands mid-batch.

Rebuilds (`build_and_publish`) run entirely outside the lock: index
construction is seconds of host numpy and device verification, and must
never stall admission or dispatch.

A port of the reference's `repro.serve.lookup.registry` for broadcast
generations on one device; its routed generation sets wait for
range-routed serving.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.core import base
from repro_torch.core import spec as spec_mod
from repro_torch.core.plan import LookupPlan
from repro_torch.kernels.common import (decode_keys, encode_keys,
                                        resolve_device)
from repro_torch.obs.trace import maybe_span
from repro_torch.serve.common import MonotonicCounter
from repro_torch.serve.lookup.dispatch import make_plan

DEFAULT_NAME = "default"


@dataclasses.dataclass(frozen=True)
class Generation:
    """One immutable, fully-built serving generation."""

    version: int
    build: base.IndexBuild
    data: Any                 # encoded sorted keys on the serving device
    plan: LookupPlan          # the build lowered to the plan IR
    fn: Callable              # plan-compiled lookup: queries -> positions
    n_keys: int
    backend: str = "torch"    # plan backend this generation serves with
    #: The validated `IndexSpec` this generation was built from, with
    #: ``backend``/``last_mile`` set to what it actually serves with.
    spec: Optional[spec_mod.IndexSpec] = None
    #: One of its keys (uint64), for the executor's warm-up batches.
    sample_key: int = 1

    def scan_fn(self, m: int) -> Callable:
        """Plan-compiled scan (positions + m-record window), cached on
        the plan per (m, backend)."""
        return self.plan.compile_scan(m, backend=self.backend)

    def fn_for(self, donate: bool = False) -> Callable:
        """The plan-compiled lookup.  ``donate`` is accepted for the
        reference's signature and changes nothing: torch has no buffer
        donation, and each batch is already a fresh device tensor."""
        return self.plan.compile(backend=self.backend)

    def instrumented_fn(self, donate: bool = False) -> Callable:
        """Plan-compiled instrumented lookup ``(q, n_valid) -> (LB,
        packed health stats)``: the same positions as ``fn`` bit for bit,
        plus the device-reduced stats the health monitor folds in
        (``donate`` as in `fn_for`)."""
        return self.plan.compile_instrumented(backend=self.backend)

    def instrumented_merged_fn(self) -> Callable:
        """Instrumented merged-view lookup ``(q, n_valid, delta) ->
        (merged LB, base-plan health stats)`` for the mutable service."""
        return self.plan.compile_instrumented_merged(backend=self.backend)


class IndexRegistry:
    """Name -> current `Generation`, with builds placed on ``device``
    (None: the CUDA card)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._versions = MonotonicCounter()
        self._current: Dict[str, Generation] = {}
        self._subscribers: list = []
        #: optional `repro_torch.obs.trace.SpanRecorder` (set by the
        #: owning service): hot-swap builds and publish instants become
        #: lifecycle spans.
        self.recorder = None
        #: optional `repro_torch.obs.health.HealthMonitor` (set by the
        #: owning service): every publish opens a per-generation health
        #: record keyed by version, so stats from a batch that completes
        #: against a just-retired generation still land in ITS record.
        self.health = None

    def subscribe(self, callback) -> None:
        """Register ``callback(name, generation)`` to run after every
        publish (outside the registry lock, on the publishing thread).
        Callbacks must be cheap or hand off."""
        with self._lock:
            self._subscribers.append(callback)

    def current(self, name: str = DEFAULT_NAME) -> Generation:
        with self._lock:
            gen = self._current.get(name)
        if gen is None:
            raise KeyError(f"no generation published under {name!r}")
        return gen

    def publish(self, build: base.IndexBuild, data,
                name: str = DEFAULT_NAME,
                last_mile: Optional[str] = None,
                backend: str = "torch",
                spec: Optional[spec_mod.IndexSpec] = None) -> Generation:
        """Lower a COMPLETE IndexBuild over encoded ``data`` to its plan,
        wrap it into a generation, and swap it in.  ``spec`` defaults to
        the spec the build carries and is re-aligned to the backend and
        last mile the generation serves with."""
        gen = self.make_generation(build, data, last_mile=last_mile,
                                   backend=backend, spec=spec)
        return self.publish_prebuilt(gen, name=name)

    def publish_prebuilt(self, gen: Generation,
                         name: str = DEFAULT_NAME) -> Generation:
        """Swap in a Generation made earlier with `make_generation`: the
        object that was checked is the one that goes live.  Health,
        trace and subscriber fan-out as in `publish`.  A generation made
        by another registry keeps its version; this registry's later
        versions stay above it."""
        with self._lock:
            self._current[name] = gen
            subscribers = list(self._subscribers)
        self._versions.advance_past(gen.version)
        if self.health is not None:
            self.health.on_publish(gen)
        if self.recorder is not None:
            self.recorder.instant("publish", cat="lifecycle", reg_name=name,
                                  version=gen.version, index=gen.plan.name,
                                  n_keys=gen.n_keys)
        for cb in subscribers:
            cb(name, gen)
        return gen

    def make_generation(self, build: base.IndexBuild, data,
                        last_mile: Optional[str] = None,
                        backend: str = "torch",
                        spec: Optional[spec_mod.IndexSpec] = None
                        ) -> Generation:
        """Lower a build to a versioned Generation WITHOUT publishing it.
        Compiling the lookup here prepares whatever the backend derives
        from the plan (RMI's fused f32 state), before the swap."""
        plan = make_plan(build, data, last_mile=last_mile)
        if spec is None:
            spec = build.meta.get("spec")
        if spec is not None:
            spec = spec.replace(backend=backend,
                                last_mile=last_mile if last_mile is not None
                                else spec.last_mile)
        return Generation(
            version=self._versions.next(),
            build=build,
            data=data,
            plan=plan,
            fn=plan.compile(backend=backend),
            n_keys=int(data.shape[0]),
            backend=backend,
            spec=spec,
            sample_key=(int(decode_keys(data[:1])[0]) if data.shape[0]
                        else 1),
        )

    def build_and_publish(self, index, keys: np.ndarray,
                          hyper: Optional[Dict[str, Any]] = None,
                          name: str = DEFAULT_NAME,
                          last_mile: Optional[str] = None,
                          backend: Optional[str] = None) -> Generation:
        """Rebuild on a fresh key set, then swap: the build is outside
        the lock, the swap is one pointer assignment.

        ``index`` is an `IndexSpec` (``hyper`` must then be None, and
        explicit ``last_mile``/``backend`` override the spec's) or a
        registry name with a ``hyper`` dict, folded into a validated spec
        so every build runs through `spec.build`.
        """
        sp = spec_mod.coerce(index, hyper, backend=backend,
                             last_mile=last_mile)
        keys = np.asarray(keys, dtype=np.uint64)
        with maybe_span(self.recorder, "index_build", cat="lifecycle",
                        reg_name=name, index=sp.index, n_keys=int(keys.size)):
            build = spec_mod.build(sp, keys, device=self.device)
            data = encode_keys(keys, self.device)
        return self.publish(build, data, name=name, last_mile=sp.last_mile,
                            backend=sp.backend, spec=sp)

    def health_records(self, window_s: float = 10.0) -> list:
        """Per-generation health records (empty when no monitor is
        attached)."""
        if self.health is None:
            return []
        return self.health.records(window_s)
