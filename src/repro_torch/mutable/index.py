"""Mutable learned index: base generation + delta, merged by rank sum.

The merged lookup is one callable per base generation:

    LB_merged(q) = LB_base(q) + LB_delta(q)

`LB_base` is the generation's `LookupPlan` (predict + bounded last mile,
`repro_torch.core.plan`) through the plan's `compile_merged` transform,
so the mutable read path runs on whatever backend the generation serves
with: on ``"cuda"`` the base rank comes from the fused ``rmi_lookup``
kernel (RMI) or from the family's predict and the ``bounded_search``
kernel.  `LB_delta` is a ``searchsorted`` over the padded device delta.
Base and delta are disjoint sorted sets, so the two lower bounds add
exactly: every position the read path returns equals a lookup over the
fully merged sorted array.

The index is addressed by an `IndexSpec` (pass one directly, or the
index/hyper/backend arguments are folded into one); every build runs
through `spec.build` on the registry's device, and an optional `Tuner`
re-runs the budget search at each compaction.

Concurrency: the only mutable cell is one `MutableView` pointer.
Inserts and compaction publishes replace it under a mutation lock;
readers grab the current view and keep a consistent (generation, delta)
PAIR for the whole batch, which is what prevents double counting when a
compaction folds delta keys into a new base.  Compaction (merge +
rebuild, plus the optional retune) runs outside every lock and publishes
through the serving registry's atomic hot swap.

The port of the reference's `repro.mutable.index`.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.core import spec as spec_mod
from repro_torch.kernels.common import encode_keys
from repro_torch.mutable.delta import PAD_QUANTUM, DeltaBuffer
from repro_torch.serve.lookup.registry import (DEFAULT_NAME, Generation,
                                               IndexRegistry)

__all__ = ["LB_INDEXES", "MutableIndex", "MutableView", "make_merged_fn"]

#: Index types with lower-bound semantics, the ones a delta can merge
#: with by rank correction.  `robin_hash` is point-only and stays
#: read-only.
LB_INDEXES = ("rmi", "pgm", "radix_spline", "btree", "ibtree", "rbs",
              "binary_search")


def make_merged_fn(plan, backend: str = "torch") -> Callable:
    """Merged lookup ``(queries, padded delta) -> merged positions``: the
    plan's delta rank-correction transform (`LookupPlan.compile_merged`).
    The delta is an ARGUMENT, not a closure constant, so one callable
    (and one captured graph a bucket) serves every delta of a pad
    length."""
    return plan.compile_merged(backend=backend)


@dataclasses.dataclass(frozen=True)
class MutableView:
    """One immutable (generation, delta) snapshot: the unit readers pin."""

    generation: Generation
    base_np: np.ndarray        # host copy of the generation's sorted keys
    delta: DeltaBuffer
    merged_fn: Callable        # shared per generation across delta updates

    def lookup(self, q):
        """Device merged lookup over an encoded query batch."""
        return self.merged_fn(q, self.delta.device)

    def scan_fn(self, m: int) -> Callable:
        """Merged-view scan ``(q, delta) -> (pos, window)``: the plan's
        `compile_merged_scan` transform, cached per (m, backend)."""
        return self.generation.plan.compile_merged_scan(
            m, backend=self.generation.backend)

    @property
    def n_keys(self) -> int:
        """Logical key count of the merged view."""
        return int(self.base_np.size) + self.delta.count


class MutableIndex:
    """Delta-buffered writes + merged reads over one registry name."""

    def __init__(self, keys: np.ndarray, index: str = "rmi",
                 hyper: Optional[Dict[str, Any]] = None,
                 last_mile: Optional[str] = None,
                 backend: str = "torch",
                 compact_threshold: int = 4096,
                 registry: Optional[IndexRegistry] = None,
                 name: str = DEFAULT_NAME,
                 pad_quantum: int = PAD_QUANTUM,
                 spec: Optional[spec_mod.IndexSpec] = None,
                 tuner: Optional[spec_mod.Tuner] = None,
                 device=None):
        """``device`` (None: the CUDA card) is where builds, the delta and
        lookups live; a given ``registry`` brings its own."""
        if compact_threshold < 1:
            raise ValueError("compact_threshold must be >= 1")
        if spec is not None:
            self.spec = spec_mod.coerce(spec, hyper)   # spec wins wholesale
        else:
            self.spec = spec_mod.coerce(index, hyper, backend=backend,
                                        last_mile=last_mile)
        self.tuner = tuner
        self.compact_threshold = int(compact_threshold)
        self.registry = (registry if registry is not None
                         else IndexRegistry(device=device))
        self.device = self.registry.device
        self.name = name
        self.pad_quantum = int(pad_quantum)
        self._mu = threading.Lock()          # view-pointer mutations
        self._compact_mu = threading.Lock()  # one compaction at a time
        self._view: Optional[MutableView] = None
        self.reset(keys)

    # -- spec-derived views (kept in sync across retunes) -----------------
    @property
    def index(self) -> str:
        return self.spec.index

    @property
    def hyper(self) -> Dict[str, Any]:
        return dict(self.spec.hyper)

    @property
    def last_mile(self) -> Optional[str]:
        return self.spec.last_mile

    @property
    def backend(self) -> str:
        return self.spec.backend

    # -- lifecycle -------------------------------------------------------
    def _view_of(self, gen: Generation, base_np: np.ndarray,
                 delta: DeltaBuffer) -> MutableView:
        return MutableView(generation=gen, base_np=base_np, delta=delta,
                           merged_fn=make_merged_fn(gen.plan, gen.backend))

    def reset(self, keys: np.ndarray) -> MutableView:
        """Replace the whole key set: fresh base, empty delta."""
        keys = np.asarray(keys, dtype=np.uint64)
        gen = self.registry.build_and_publish(self.spec, keys,
                                              name=self.name)
        view = self._view_of(gen, keys,
                             DeltaBuffer.empty(self.pad_quantum, self.device))
        with self._mu:
            self._view = view
        return view

    # -- read side -------------------------------------------------------
    def view(self) -> MutableView:
        with self._mu:
            return self._view

    def lookup(self, q) -> np.ndarray:
        """Host convenience: merged LB positions as int64 numpy."""
        qt = encode_keys(np.asarray(q, dtype=np.uint64), self.device)
        return self.view().lookup(qt).cpu().numpy().astype(np.int64)

    # -- write side ------------------------------------------------------
    def insert(self, keys) -> np.ndarray:
        """Admit keys into the delta (set semantics); returns the 0/1
        admitted flag per input key."""
        with self._mu:
            view = self._view
            delta, admitted = view.delta.with_inserted(view.base_np, keys)
            if delta is not view.delta:
                self._view = dataclasses.replace(view, delta=delta)
        return admitted

    @property
    def delta_count(self) -> int:
        return self.view().delta.count

    @property
    def needs_compaction(self) -> bool:
        return self.delta_count >= self.compact_threshold

    # -- autotune apply --------------------------------------------------
    def republish(self, spec, build=None) -> Optional[Generation]:
        """Hot-swap the base generation to a new spec WITHOUT folding the
        delta (the autotune retuner's apply path).  The base key set is
        unchanged, so a caller's verified build for it is published as
        is, and the delta carries over verbatim.  Returns None if a
        reset or compaction replaced the base mid-flight."""
        with self._compact_mu:
            snap = self.view()
            new_spec = spec_mod.coerce(spec)
            b = build if build is not None \
                else spec_mod.build(new_spec, snap.base_np,
                                    device=self.device)
            b.meta["spec"] = new_spec
            with self._mu:
                if self._view.generation is not snap.generation:
                    return None
                gen = self.registry.publish(b, snap.generation.data,
                                            name=self.name,
                                            last_mile=new_spec.last_mile,
                                            backend=new_spec.backend,
                                            spec=new_spec)
                self.spec = new_spec
                self._view = self._view_of(gen, snap.base_np,
                                           self._view.delta)
            return gen

    # -- compaction ------------------------------------------------------
    def compact(self) -> Optional[Generation]:
        """Fold the current delta into a fresh base generation.

        Snapshot -> merge -> (retune) -> rebuild -> hot-swap publish.
        The rebuild runs outside every lock; the publish + pointer swap
        hold the mutation lock, so inserts admitted DURING the rebuild
        are preserved: the new view keeps exactly the keys the snapshot
        did not cover.  If a `reset` replaced the whole key set
        mid-rebuild, the snapshot's generation is no longer current and
        the rebuild is discarded.  Returns the new generation, or None if
        the delta was empty or the rebuild was abandoned.
        """
        with self._compact_mu:
            snap = self.view()
            if snap.delta.count == 0:
                return None
            merged_keys = np.concatenate([snap.base_np, snap.delta.keys_np])
            merged_keys.sort(kind="stable")
            if self.tuner is not None:
                result = self.tuner.tune(merged_keys, device=self.device)
                new_spec, build = result.spec, result.build
                # with a single candidate backend the tuner chose none, so
                # the serving backend survives; an unset last mile stays
                if len(self.tuner.backends) == 1:
                    new_spec = new_spec.replace(backend=self.spec.backend)
                if new_spec.last_mile is None and \
                        self.spec.last_mile is not None:
                    new_spec = new_spec.replace(
                        last_mile=self.spec.last_mile)
                build.meta["spec"] = new_spec
            else:
                new_spec = self.spec
                build = spec_mod.build(new_spec, merged_keys,
                                       device=self.device)
            data = encode_keys(merged_keys, self.device)
            # lowering and compiling (RMI's f32 state on cuda) before the
            # lock: the publish itself only swaps pointers
            gen = self.registry.make_generation(
                build, data, last_mile=new_spec.last_mile,
                backend=new_spec.backend, spec=new_spec)
            with self._mu:
                if self._view.generation is not snap.generation:
                    return None   # reset() raced the rebuild: stale, drop it
                self.registry.publish_prebuilt(gen, name=self.name)
                self.spec = new_spec
                leftover = self._view.delta.minus(snap.delta)
                self._view = self._view_of(gen, merged_keys, leftover)
            return gen
