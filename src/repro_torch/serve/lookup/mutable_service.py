"""`MutableLookupService`: reads AND writes through one admission queue.

The mutable face of the lookup service.  Inserts are admitted through
the very same `MicroBatcher` as reads, tagged ``kind="insert"``, so a
single flusher sees one total admission order and applies it
faithfully: a taken batch is split into consecutive same-kind runs;
insert runs land in the `MutableIndex` delta (futures resolve to per-key
0/1 admitted flags), read runs pin ONE (generation, delta) view and
dispatch the merged lookup.  That ordering is exactly what the
oracle-replay invariant is stated against: any read admitted after an
insert observes it once flushed.  Both executors: on the async one an
insert run is applied on the dispatch thread when it is reached, and the
merged read's delta is a bound operand of the cached graph.  Over
several cards each slice's merged lookup binds its own card's copy of
the pinned delta (`DeltaBuffer.on`), so an insert is seen on every card
at its next batch.

Compaction: after an insert run pushes the delta past
``compact_threshold``, a background compaction thread folds base + delta
into a fresh generation through the registry's hot swap and prunes the
delta to the keys admitted mid-rebuild.  Reads in flight complete against
the view they pinned; compaction never changes merged content, only
where it lives, so results are invariant across the swap.

The port of the reference's `repro.serve.lookup.mutable_service`.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.core import spec as spec_mod
from repro_torch.obs.trace import maybe_span
from repro_torch.serve.lookup.admission import LookupFuture
from repro_torch.serve.lookup.executor import AsyncContext, WorkItem
from repro_torch.serve.lookup.registry import DEFAULT_NAME, Generation
from repro_torch.serve.lookup.service import (LookupService,
                                              LookupServiceConfig)

__all__ = ["MutableLookupService", "MutableLookupServiceConfig"]


@dataclasses.dataclass(frozen=True)
class MutableLookupServiceConfig(LookupServiceConfig):
    compact_threshold: int = 4096   # delta keys that trigger a compaction
    auto_compact: bool = True       # spawn the background compactor
    #: Optional budget tuner: when set, every compaction re-runs the spec
    #: search against the delta-merged key set.
    tuner: Optional[spec_mod.Tuner] = None


class MutableLookupService(LookupService):
    #: seconds to wait before respawning the compactor after a failed
    #: compaction: bounds rebuild churn when every rebuild is doomed
    COMPACT_RETRY_BACKOFF_S = 5.0

    def __init__(self, keys: np.ndarray,
                 config: Optional[MutableLookupServiceConfig] = None,
                 device=None, counter=None, devices=None):
        """Serve reads and inserts over ``keys`` on ``device``, or over
        the list ``devices`` (neither: every visible CUDA card)."""
        self.mindex = None   # MutableIndex, created by the first swap_keys
        self._compact_thread: Optional[threading.Thread] = None
        self._compact_spawn_mu = threading.Lock()
        self._compact_fail_t: Optional[float] = None
        self.last_compaction_error: Optional[BaseException] = None
        cfg = config if config is not None else MutableLookupServiceConfig()
        if cfg.topology is not None or cfg.shards > 1:
            # the merged (base + delta) view is a single global rank
            # space; range-routing it needs per-shard delta partitioning
            raise ValueError(
                "MutableLookupService does not support a routed topology"
                " yet — serve writes through a broadcast service")
        super().__init__(keys, config=cfg, device=device, counter=counter,
                         devices=devices)

    # -- index lifecycle -------------------------------------------------
    def swap_keys(self, keys: np.ndarray) -> Generation:
        """Replace the WHOLE key set (fresh base, empty delta)."""
        # deferred import: repro_torch.mutable depends on this package
        from repro_torch.mutable.index import MutableIndex

        if self.mindex is None:
            self.mindex = MutableIndex(
                keys, spec=self.cfg.resolved_spec(),
                tuner=self.cfg.tuner,
                compact_threshold=self.cfg.compact_threshold,
                registry=self.registry, name=DEFAULT_NAME,
                pad_quantum=self.cfg.pad_quantum)
            view = self.mindex.view()
        else:
            view = self.mindex.reset(keys)
        self.metrics.set_delta_gauge(
            delta_keys=0, threshold=self.cfg.compact_threshold)
        if self.health is not None:
            self.health.note_delta(0, self.cfg.compact_threshold)
        return view.generation

    # -- client surface --------------------------------------------------
    def insert(self, keys, client=None) -> LookupFuture:
        """Admit an insert request; the future resolves to an int64 0/1
        admitted flag per input key (0 = key already present)."""
        _, fut = self.batcher.submit(keys, kind="insert", client=client)
        return fut

    # -- flusher ---------------------------------------------------------
    def _process_batch(self, batch) -> None:
        """Unlike the immutable service (one pinned context per batch),
        the context re-pins PER RUN: an insert run changes the delta,
        and a read/scan run admitted after it in the same batch must
        observe it."""
        for run in self._runs(batch, key=lambda r: r.kind):
            self._dispatch_run(run[0].kind, run)   # ctx=None: pin per run

    def _dispatch_run(self, kind: str, run, ctx=None) -> None:
        """Insert runs land in the delta; reads and scans route through
        the base service's kind dispatcher."""
        if kind == "insert":
            self._apply_inserts(run)
        else:
            super()._dispatch_run(kind, run, ctx)

    def _slice_views(self, view):
        """``(generation copy, delta copy)`` each dispatcher slice
        reads, in slice order."""
        return [(view.generation.on(d), view.delta.on(d))
                for d in self.devices]

    def _pin_context(self):
        """Each run pins one immutable (generation, delta) PAIR, the
        atomic unit that keeps a concurrent compaction from being
        observed half-applied, read on each slice's card from that
        card's copies.  Scans go through the plan's merged-scan
        transform; with health on, reads run the instrumented merged
        lookup (merged ranks, base-plan stats)."""
        view = self.mindex.view()
        pairs = self._slice_views(view)

        def scan_for(m: int):
            return tuple((lambda q, f=g.merged_scan_fn(m), d=d: f(q, d))
                         for g, d in pairs)

        if self.health is not None:
            fns = tuple((lambda q, n_valid, f=g.instrumented_merged_fn(),
                         d=d: f(q, n_valid, d)) for g, d in pairs)
        else:
            fns = tuple((lambda q, f=g.merged_fn(), d=d: f(q, d))
                        for g, d in pairs)
        return fns, scan_for, view.generation.version

    def _insert_apply(self, run) -> np.ndarray:
        """Land one insert run in the delta (host-side, in admission
        order) and record the write-side metrics; returns the per-key
        admitted flags.  Shared by both executors."""
        keys = (run[0].keys if len(run) == 1
                else np.concatenate([r.keys for r in run]))
        t0 = time.perf_counter()
        admitted = self.mindex.insert(keys)
        self.metrics.observe_insert_batch(
            n_keys=keys.size, admitted=int(admitted.sum()),
            t_start=t0, t_end=time.perf_counter())
        self.metrics.set_delta_gauge(
            delta_keys=self.mindex.delta_count,
            threshold=self.mindex.compact_threshold)
        if self.health is not None:
            self.health.note_delta(self.mindex.delta_count,
                                   self.mindex.compact_threshold)
        if self.cfg.auto_compact and self.mindex.needs_compaction:
            self._spawn_compaction()
        return admitted

    def _apply_inserts(self, run) -> None:
        t0 = time.perf_counter()
        try:
            admitted = self._insert_apply(run)
        except BaseException as e:  # noqa: BLE001 — fail the run, not the flusher
            for r in run:
                r.future._set_exception(e)
            return
        off = 0
        for r in run:
            r.future._set_result(admitted[off:off + r.keys.size])
            off += r.keys.size
        if self.recorder is not None:
            t_end = time.perf_counter()
            for r in run:
                self.recorder.request(r.rid, kind="insert",
                                      n_keys=r.keys.size,
                                      t_submit=r.t_submit,
                                      t_launch=t0, t_end=t_end)

    # -- async executor plumbing -----------------------------------------
    def _async_context(self):
        """Pin one (generation, delta) view as cacheable contexts, one a
        slice, each binding its card's copies.  The merged fn takes the
        padded delta as an ARGUMENT (``bind``), so the cached graph
        survives insert traffic; the padded delta LENGTH is part of the
        key: a pow2 pad-boundary crossing is a (correct, observable)
        miss."""
        view = self.mindex.view()
        instrumented = self.health is not None
        key = (view.generation.version, int(view.delta.device.shape[0]))
        return tuple(AsyncContext(
            key=key,
            read_fn=(g.instrumented_merged_fn() if instrumented
                     else g.merged_fn()),
            scan_fn=g.merged_scan_fn,
            bind=(d,),
            sample_key=view.generation.sample_key,
            instrumented=instrumented) for g, d in self._slice_views(view))

    def _async_work_items(self, batch):
        """Re-pin PER RUN (the sync `_process_batch` contract): an insert
        item is applied when the executor reaches it, and the generator
        resumes with a fresh view for the next run."""
        for run in self._runs(batch, key=lambda r: r.kind):
            kind = run[0].kind
            if kind == "insert":
                yield WorkItem(kind="insert", group=list(run),
                               apply_fn=self._insert_apply)
            else:
                yield from self._async_items_for_run(
                    kind, run, self._async_context())

    def _complete_insert_slot(self, slot) -> None:
        """Resolve a host-ready insert slot in ring order: results were
        computed at apply time; completion only keeps FIFO semantics."""
        admitted = slot.host
        off = 0
        for r in slot.group:
            r.future._set_result(admitted[off:off + r.keys.size])
            off += r.keys.size
        if self.recorder is not None:
            t_end = time.perf_counter()
            for r in slot.group:
                self.recorder.request(r.rid, kind="insert",
                                      n_keys=r.keys.size,
                                      t_submit=r.t_submit,
                                      t_launch=slot.t_launch, t_end=t_end)

    # -- compaction ------------------------------------------------------
    def _spawn_compaction(self) -> None:
        with self._compact_spawn_mu:
            if self._compact_thread is not None \
                    and self._compact_thread.is_alive():
                return   # one compactor at a time; it re-checks on exit
            if (self._compact_fail_t is not None
                    and time.perf_counter() - self._compact_fail_t
                    < self.COMPACT_RETRY_BACKOFF_S):
                return   # recent failure: back off instead of churning
            t = threading.Thread(target=self._compact_and_record,
                                 name="lookup-compactor", daemon=True)
            self._compact_thread = t
            t.start()

    def _compact_and_record(self, reraise: bool = False
                            ) -> Optional[Generation]:
        t0 = time.perf_counter()
        try:
            with maybe_span(self.recorder, "compaction", cat="lifecycle",
                            delta_keys=int(self.mindex.delta_count)):
                gen = self.mindex.compact()
        except BaseException as e:  # noqa: BLE001 — observable, not thread-fatal
            self.metrics.observe_compaction_failure()
            self.last_compaction_error = e
            self._compact_fail_t = time.perf_counter()
            if reraise:
                raise
            return None
        if gen is None:
            return None
        self._compact_fail_t = None
        self.last_compaction_error = None
        self.metrics.observe_compaction(duration_s=time.perf_counter() - t0)
        self.metrics.set_delta_gauge(
            delta_keys=self.mindex.delta_count,
            threshold=self.mindex.compact_threshold)
        if self.health is not None:
            self.health.note_delta(self.mindex.delta_count,
                                   self.mindex.compact_threshold)
        return gen

    def force_compact(self) -> Optional[Generation]:
        """Synchronous compaction; waits for any in-flight background
        compaction first, then folds what remains.  Unlike the
        background path, a failing rebuild raises here."""
        t = self._compact_thread
        if t is not None and t.is_alive():
            t.join()
        return self._compact_and_record(reraise=True)

    def stop(self) -> None:
        super().stop()
        t = self._compact_thread
        if t is not None and t.is_alive():
            t.join()
