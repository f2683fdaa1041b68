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

A `RoutedGeneration` is one published SET of per-shard generations plus
the `ShardTopology` that routes into them, swapped in as one unit.

Replicas: a registry serves on a list of devices (one card, every card,
or any list; a device may repeat).  A generation is lowered, and its
bounds and any fused state verified, once, on the device its build lies
on; it is then copied to each other device it is served from
(`LookupPlan.to`), and `Generation.on` names the copy a device reads.
The copies are made before the publish, so a publish swaps every card's
replica as one unit.  A broadcast generation is placed on every serving
device, a routed shard on the devices of its replica group
(`shard_replica_groups`).

A port of the reference's `repro.serve.lookup.registry`.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import base
from repro_torch.core import spec as spec_mod
from repro_torch.core.plan import LookupPlan, _window_gather
from repro_torch.kernels.common import (decode_keys, encode_keys,
                                        resolve_device)
from repro_torch.obs.trace import maybe_span
from repro_torch.serve.common import MonotonicCounter
from repro_torch.serve.lookup.dispatch import make_plan
from repro_torch.serve.lookup.topology import (ShardTopology,
                                               shard_replica_groups)

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
    #: Shard index inside a `RoutedGeneration` (None for broadcast
    #: generations), threaded into per-shard health records.
    shard: Optional[int] = None
    #: device -> this generation copied there (`place`), the same
    #: version: the copies every other serving device reads
    _replicas: Dict[torch.device, "Generation"] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        """The device this copy's keys and plan lie on."""
        return self.data.device

    def on(self, device) -> "Generation":
        """This generation's copy on ``device``: itself on its own device,
        else a replica made by `place`.  A device it was never placed on
        raises: no other device's copy serves in its stead."""
        device = torch.device(device)
        if device == self.device:
            return self
        gen = self._replicas.get(device)
        if gen is None:
            raise KeyError(f"generation {self.version} has no replica on "
                           f"{device}")
        return gen

    def place(self, devices) -> "Generation":
        """Copy this generation to each of ``devices`` it is not on yet:
        the same verified plan state and keys (`LookupPlan.to`), a plan
        cache of its own, the lookup compiled on the copy.  Returns
        itself."""
        with _PLACE_LOCK:
            for dev in devices:
                dev = torch.device(dev)
                if dev == self.device or dev in self._replicas:
                    continue
                plan = self.plan.to(dev)
                self._replicas[dev] = dataclasses.replace(
                    self, build=dataclasses.replace(
                        self.build, state=plan.bounds.state),
                    data=plan.data, plan=plan,
                    fn=plan.compile(backend=self.backend), _replicas={})
        return self

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

    def merged_fn(self) -> Callable:
        """Merged-view lookup ``(q, delta) -> merged LB``."""
        return self.plan.compile_merged(backend=self.backend)

    def merged_scan_fn(self, m: int) -> Callable:
        """Merged-view scan ``(q, delta) -> (merged LB, m-record
        window)``."""
        return self.plan.compile_merged_scan(m, backend=self.backend)


#: serializes `Generation.place` (a publish and a rebalance may place the
#: same generation at once)
_PLACE_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True, eq=False)
class RoutedGeneration:
    """One published *set* of per-shard generations plus the topology
    that routes into them.

    Swaps atomically as a unit: the registry pointer flips to the whole
    RoutedGeneration, so a pinned batch observes one consistent
    (topology, shard builds) pair even while a re-publish is in flight.
    Shard ``s`` serves keys in ``(split[s-1], split[s]]`` with its own
    (smaller, possibly separately tuned) plan; the routed global rank is
    ``topology.offsets[s] + LB_local``.
    """

    version: int
    topology: ShardTopology
    shards: Tuple[Generation, ...]
    spec: Optional[spec_mod.IndexSpec] = None
    backend: str = "torch"
    _scan_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_keys(self) -> int:
        return self.topology.n_keys

    @property
    def shard_versions(self) -> Tuple[int, ...]:
        return tuple(s.version for s in self.shards)

    @property
    def plan(self) -> LookupPlan:
        """First shard's plan: a shape/name probe only; never dispatch
        through it directly (it covers one key range)."""
        return self.shards[0].plan

    @property
    def point_only(self) -> bool:
        return any(s.plan.point_only for s in self.shards)

    @property
    def max_err(self) -> int:
        return max(s.plan.bounds.max_err for s in self.shards)

    @property
    def max_scan_len(self) -> int:
        """Largest exact routed scan width: a shard-s window is repaired
        with the first ``m`` records of shard s+1, which only covers the
        spill when every shard holds at least ``m`` keys."""
        return self.topology.min_shard_len

    def shard_scan_fn(self, s: int, m: int, device=None) -> Callable:
        """Scan for shard ``s`` on ``device`` (None: the shard's own):
        the shard-local window merged with the head of shard ``s+1``,
        both read from the copies on that device.  All shard-s records
        sort strictly below all shard-(s+1) records (boundaries are
        snapped to duplicate runs), so the first ``m`` of the sorted
        union is exactly the global window, the same argument as the
        delta merged scan.  The
        sort runs on encoded keys, where the window's past-the-end pad
        (``INT64_MAX``, the code of ``UINT64_MAX``) sorts last; decoding
        happens at completion.  Tagged with the shard's plan, so the
        executor captures it as a CUDA graph like the plan's own scan."""
        gen = self.shards[s]
        gen = gen.on(gen.device if device is None else device)
        key = (int(s), int(m), gen.device)
        fn = self._scan_cache.get(key)
        if fn is not None:
            return fn
        if s == len(self.shards) - 1:
            fn = gen.scan_fn(m)          # the pad is global here
        else:
            run = gen.plan.compile(backend=gen.backend)
            data = gen.plan.data
            head = self.shards[s + 1].data[:m].to(gen.device)

            def scan(q):
                pos = run(q)
                wb = _window_gather(data, pos, m)
                spill = head[None, :].expand(q.shape[0], m)
                merged = torch.sort(torch.cat([wb, spill], dim=1),
                                    dim=1).values[:, :m]
                return pos, merged

            scan.lookup_plan = gen.plan
            fn = scan
        self._scan_cache[key] = fn
        return fn


class IndexRegistry:
    """Name -> current `Generation`, served from ``devices`` (a device
    may repeat) or from the one ``device`` (None: the current CUDA card).
    Builds run on the first device, which `device` names."""

    def __init__(self, device=None, devices=None):
        if devices is not None and device is not None:
            raise ValueError("pass device or devices, not both")
        self.devices = ([resolve_device(d) for d in devices]
                        if devices is not None else [resolve_device(device)])
        if not self.devices:
            raise ValueError("a registry needs at least one device")
        self.device = self.devices[0]
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
        object that was checked is the one that goes live, placed first
        on every device of this registry it is not on yet.  Health,
        trace and subscriber fan-out as in `publish`.  A generation made
        by another registry keeps its version; this registry's later
        versions stay above it."""
        gen.place(self.devices)
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
                        spec: Optional[spec_mod.IndexSpec] = None,
                        shard: Optional[int] = None,
                        devices=None) -> Generation:
        """Lower a build to a versioned Generation WITHOUT publishing it
        (the routed publish path assembles several of these and swaps
        them in as one unit), over encoded ``data`` on the build's
        device.  Compiling the lookup here prepares whatever the backend
        derives from the plan (RMI's fused f32 state), before the swap;
        the generation is then placed on ``devices`` (None: every device
        of this registry)."""
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
            shard=shard,
        ).place(self.devices if devices is None else devices)

    def shard_devices(self, topology: ShardTopology):
        """Each shard's replica group over this registry's devices: the
        devices its lanes run on (`shard_replica_groups`)."""
        return shard_replica_groups(self.devices, topology.replicas)

    def publish_routed(self, shard_gens, topology: ShardTopology,
                       name: str = DEFAULT_NAME,
                       spec: Optional[spec_mod.IndexSpec] = None,
                       backend: str = "torch") -> RoutedGeneration:
        """Swap a complete shard set in as one RoutedGeneration, each
        shard placed first on its replica group's devices
        (`shard_devices`).  Shard generations made by another registry
        keep their versions; this registry's later versions stay above
        them."""
        for g, grp in zip(shard_gens, self.shard_devices(topology)):
            g.place(grp)
            self._versions.advance_past(g.version)
        rgen = RoutedGeneration(
            version=self._versions.next(),
            topology=topology,
            shards=tuple(shard_gens),
            spec=spec,
            backend=backend,
        )
        with self._lock:
            self._current[name] = rgen
            subscribers = list(self._subscribers)
        if self.health is not None:
            self.health.on_publish_group(rgen.shards)
        if self.recorder is not None:
            self.recorder.instant(
                "publish", cat="lifecycle", reg_name=name,
                version=rgen.version, index=rgen.plan.name,
                n_keys=rgen.n_keys, n_shards=topology.n_shards)
        for cb in subscribers:
            cb(name, rgen)
        return rgen

    def build_and_publish_routed(self, index, keys: np.ndarray,
                                 topology: ShardTopology,
                                 hyper: Optional[Dict[str, Any]] = None,
                                 name: str = DEFAULT_NAME,
                                 last_mile: Optional[str] = None,
                                 backend: Optional[str] = None,
                                 tuner: Optional[spec_mod.Tuner] = None
                                 ) -> RoutedGeneration:
        """Build one generation per topology range and swap the set in.

        With a ``tuner``, each shard's spec is searched against ONLY its
        slice (per-shard byte budget = total / shards); without one,
        every shard reuses the coerced spec: smaller slices still give
        tighter error bounds for the same hyperparameters.  Each shard's
        bounds are verified by its own build, on the first device of its
        replica group (a tuned build: on this registry's device), and the
        shard is placed on that group.
        """
        sp = spec_mod.coerce(index, hyper, backend=backend,
                             last_mile=last_mile)
        keys = np.asarray(keys, dtype=np.uint64)
        offs = topology.offsets
        shard_specs = [sp] * topology.n_shards
        builds = [None] * topology.n_shards
        if tuner is not None:
            results = tuner.tune_shards(keys, offs, device=self.device)
            shard_specs = [r.spec for r in results]
            builds = [r.build for r in results]
        gens = []
        groups = self.shard_devices(topology)
        with maybe_span(self.recorder, "index_build", cat="lifecycle",
                        reg_name=name, index=sp.index,
                        n_keys=int(keys.size),
                        n_shards=topology.n_shards):
            for s in range(topology.n_shards):
                sl = keys[offs[s]:offs[s + 1]]
                b = builds[s] if builds[s] is not None \
                    else spec_mod.build(shard_specs[s], sl,
                                        device=groups[s][0])
                gens.append(self.make_generation(
                    b, encode_keys(sl, b.device),
                    last_mile=shard_specs[s].last_mile,
                    backend=shard_specs[s].backend,
                    spec=shard_specs[s], shard=s, devices=groups[s]))
        return self.publish_routed(gens, topology, name=name, spec=sp,
                                   backend=sp.backend)

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
