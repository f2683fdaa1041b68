"""Dispatch: one plan-compiled lookup over a padded query batch, split
over the devices of the data axis.

A batch of uint64 request keys is padded to a power-of-two bucket, then
up to a multiple of the device count, encoded (`kernels.common` codec)
into a pinned host staging buffer of that bucket, and split into one
contiguous equal slice a device.  Slice k is copied to device k without
blocking and run through a `repro_torch.core.plan.LookupPlan` callable
over device k's replica of the generation: pass a plan and the
dispatcher compiles (and caches) the lookup for the requested backend on
each device's copy, or pass the lookup callables (a scan or instrumented
lookup), one a slice.  At completion the slices come back in order and
the pad lanes are sliced off.  The bucket bounds the distinct batch
shapes at log2(max batch).  Pad lanes repeat the first real key; an
instrumented read passes each slice its own count of real keys, so its
pad lanes stay masked, and folds the slices' stats vectors into the one
vector a single device returns (`obs.health.fold_stats`).

This is the reference's `repro.serve.lookup.dispatch.ShardedDispatcher`:
its 1-D ``data`` mesh is the list of devices (`data_axis_devices`, every
visible card), ``n_shards`` the list's length, and the answers are the
one device's bit for bit, since every lane is an independent search over
the same keys.  Devices may repeat: slices on one device share its
replica.  Range-routed dispatch (`RoutedDispatcher`) runs one
single-device dispatcher per (shard, replica) lane, on the lane's device.

Staging reuse: the host-to-device copies of a pinned buffer are
asynchronous, and the next batch of the same bucket pads into the same
buffer.  Returning while a copy is in flight would let that pad
overwrite this batch's queries (the race the reference fixed by
blocking on its placement).  So a CUDA event is recorded after each
slice's copy, one per (device, bucket), and the next write into that
bucket's buffer waits on them.  On the CPU the placement is a copy, so
the staging buffer never aliases a batch either.

Two faces.  The synchronous `__call__` launches every slice and then
`complete`s (reads the results back with ``.cpu()``, which waits for each
device).  The async executor uses the split halves instead: `launch`
stages the batch and, for each slice on its device's stream (the
executor's own for that card), copies the slice to the device (straight
into a captured graph's static input when the executable has one), runs
the slice's executable, and enqueues a ``non_blocking`` copy of every
output into a pinned host set of the slice's own, followed by an event;
`complete` waits on those events and copies the outputs out of the host
sets (a result outlives the slot, whose buffers a later launch reuses).
Waiting on the launch's own events (never ``.cpu()``) leaves the batches
launched after it running, and copying the outputs right after the
replay, in stream order, keeps them safe from the next replay of the
same graph, which rewrites its static outputs.  A slice that fails to
launch fails the batch: the slices already launched are waited for, and
no other device answers in its stead.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import plan as plan_mod
from repro_torch.kernels.common import SIGN_BIT, decode_keys, resolve_device
from repro_torch.obs.health import fold_stats
from repro_torch.obs.trace import maybe_span
from repro_torch.serve.lookup.topology import shard_replica_groups

#: Smallest dispatch width: keeps tiny deadline-flush batches from
#: producing one shape per size.
PAD_QUANTUM = 128


def make_plan(build, data, last_mile=None):
    """Lower one index generation to its `LookupPlan` over encoded
    ``data``.  ``last_mile`` defaults to the hyperparameter the index was
    built with, falling back to binary."""
    return plan_mod.lower(build, data, last_mile=last_mile)


def data_axis_devices() -> List[torch.device]:
    """Every visible CUDA card, in index order: the port's counterpart of
    the reference's `data_axis_mesh` (a 1-D ``data`` mesh over
    ``jax.devices()``).  Without a card it raises, as `resolve_device`
    does: nothing carries on on the CPU unless asked."""
    resolve_device(None)
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def serving_devices(device=None, devices=None) -> List[torch.device]:
    """The devices one service serves on: ``device`` pins one,
    ``devices`` lists them (a device may repeat), and neither means every
    visible card (`data_axis_devices`), as the reference's services
    default to every local device.  Each comes back normalized
    (`resolve_device`); a card that is not there raises."""
    if device is not None and devices is not None:
        raise ValueError("pass device or devices, not both")
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("devices must name at least one device")
        return devs
    if device is not None:
        return [resolve_device(device)]
    return data_axis_devices()


def distinct(devices) -> List[torch.device]:
    """``devices`` without repeats, in first-seen order."""
    out: List[torch.device] = []
    for d in devices:
        if d not in out:
            out.append(d)
    return out


def device_guard(device):
    """``torch.cuda.device(device)`` for a CUDA device (its kernels and
    streams are the current ones inside), nothing for another."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _host_copy(out, host: Dict, key=()):
    """Enqueue a copy of every tensor of ``out`` into a pinned host
    buffer of ``host`` (one per output position, shape and dtype, made on
    first use); same nesting as ``out``."""
    if isinstance(out, tuple):
        return tuple(_host_copy(o, host, key + (i,))
                     for i, o in enumerate(out))
    k = (key, tuple(out.shape), out.dtype)
    buf = host.get(k)
    if buf is None:
        buf = host[k] = torch.empty(out.shape, dtype=out.dtype,
                                    pin_memory=True)
    buf.copy_(out, non_blocking=True)
    return buf


def _own(out):
    """Copies of the host tensors of ``out`` in pageable memory: results
    must outlive the pinned buffers they were copied into."""
    if isinstance(out, tuple):
        return tuple(_own(o) for o in out)
    return out.clone()


def _to_host(out):
    """``out`` read back to the host (waits for its device)."""
    if isinstance(out, tuple):
        return tuple(_to_host(o) for o in out)
    return out.cpu()


def _join(parts, instrumented: bool):
    """One batch's output from its slices' host outputs, in slice order:
    positions and windows concatenated, an instrumented read's stats
    vectors folded (`fold_stats`)."""
    if instrumented:
        payload = _join([p[0] for p in parts], False)
        return payload, torch.from_numpy(
            fold_stats([p[1].numpy() for p in parts]))
    if len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(col) for col in zip(*parts))
    return torch.cat(parts)


@dataclasses.dataclass
class Launched:
    """One batch launched by `ShardedDispatcher.launch`: each slice's
    outputs (host copies in flight on a CUDA device, the outputs
    themselves on the CPU) and the events recorded after the copies."""

    parts: List[Any]
    m: int
    instrumented: bool = False
    done: List[Any] = dataclasses.field(default_factory=list)


class ShardedDispatcher:
    """Pads, stages, splits and runs query batches over the data axis."""

    def __init__(self, device=None, pad_quantum: int = PAD_QUANTUM,
                 recorder=None, devices=None):
        #: the data axis: slice k of a batch runs on ``devices[k]``
        self.devices = tuple(serving_devices(device, devices))
        #: the first device (where the builds run)
        self.device = self.devices[0]
        self.n_shards = len(self.devices)
        self.pad_quantum = int(pad_quantum)
        #: optional `repro_torch.obs.trace.SpanRecorder`: the dispatch
        #: path splits into a pad+place span (host-side data movement)
        #: and a device span (launch + wait), so a slow batch names which
        #: half it spent its time in.
        self.recorder = recorder
        # one staging buffer per bucket (pinned on a CUDA device), and
        # the events recorded after the copies out of it, one a slice
        self._staging: Dict[int, torch.Tensor] = {}
        self._copied: Dict[int, List[torch.cuda.Event]] = {}
        self.staging_hits = 0
        self.staging_allocs = 0

    def padded_size(self, m: int) -> int:
        """The smallest ``pad_quantum * 2^k`` that holds ``m`` keys, then
        up to a multiple of the device count (the reference's)."""
        p = self.pad_quantum
        while p < m:
            p <<= 1
        r = p % self.n_shards
        return p + (self.n_shards - r if r else 0)

    def slice_valid(self, m: int, p: int) -> List[int]:
        """The real keys in each slice of an ``m``-key batch padded to
        ``p``: ``clamp(m - k*p/n, 0, p/n)``."""
        s = p // self.n_shards
        return [min(max(m - k * s, 0), s) for k in range(self.n_shards)]

    def _stage(self, keys: np.ndarray):
        """Pad ``keys`` to their bucket and encode them into the bucket's
        staging buffer; returns ``(buffer, padded size)``."""
        m = keys.size
        p = self.padded_size(m)
        buf = self._staging.get(p)
        if buf is None:
            buf = torch.empty(p, dtype=torch.int64, pin_memory=any(
                d.type == "cuda" for d in self.devices))
            self._staging[p] = buf
            self.staging_allocs += 1
        else:
            self.staging_hits += 1
            copied = self._copied.get(p)
            if copied:
                # the last copies out of buf are done
                with maybe_span(self.recorder, "stage_wait", cat="serve",
                                padded=int(p)):
                    for ev in copied:
                        ev.synchronize()
        self._copied[p] = []
        host = buf.numpy().view(np.uint64)
        np.bitwise_xor(keys, np.uint64(SIGN_BIT), out=host[:m])
        host[m:] = host[0]       # any valid key: lanes are independent
        return buf, p

    def _place(self, buf, p: int, k: int, dst=None):
        """Slice ``k`` of staging buffer ``buf`` on its device (into
        ``dst`` when given).  On a CUDA device the copy goes on the
        current stream and records the event the buffer's next write
        waits on."""
        s = p // self.n_shards
        src, dev = buf[k * s:(k + 1) * s], self.devices[k]
        if dev.type != "cuda":
            return src.clone()
        if dst is None:
            dst = src.to(dev, non_blocking=True)
        else:
            dst.copy_(src, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(dev))
        self._copied[p].append(copied)
        return dst

    def pad_and_place(self, keys: np.ndarray):
        """Pad to the bucket, encode into the bucket's staging buffer and
        place each slice on its device; returns ``(device slices of
        encoded keys, padded size)``."""
        buf, p = self._stage(np.asarray(keys, dtype=np.uint64))
        return tuple(self._place(buf, p, k)
                     for k in range(self.n_shards)), p

    def launch(self, exes: Sequence, keys: np.ndarray, binds: Sequence,
               hosts: Sequence[Dict], instrumented: bool = False,
               streams: Optional[Dict] = None) -> Launched:
        """The launch half of async dispatch: stage the batch, then for
        each slice k on its device, place it, run ``exes[k](q, [n_valid,]
        *binds[k])`` and enqueue the copy of its outputs into the pinned
        buffers of ``hosts[k]`` (a set of the slice's own, made on first
        use), on ``streams[device]`` (the executor's stream for that
        card; None or missing: the device's current stream), without
        waiting on the device.  An executable with a ``static_input`` (a
        captured graph) gets its slice copied straight into it.
        ``instrumented`` says the outputs are ``(payload, packed
        stats)``: each slice then gets its own count of real keys.
        Returns a `Launched` for `complete`.

        Device operands in ``binds`` (a padded delta) were made on the
        caller's stream: the launch stream first waits for everything
        queued on it, and each operand is marked as used on the launch
        stream, so the caching allocator does not hand its memory out
        again before this launch has read it."""
        keys = np.asarray(keys, dtype=np.uint64)
        m = keys.size
        buf, p = self._stage(keys)
        valid = self.slice_valid(m, p)
        launched = Launched(parts=[], m=m, instrumented=instrumented)
        try:
            for k, dev in enumerate(self.devices):
                exe, bind = exes[k], tuple(binds[k])
                args = ((valid[k],) if instrumented else ()) + bind
                if dev.type != "cuda":
                    launched.parts.append(exe(self._place(buf, p, k), *args))
                    continue
                stream = (streams or {}).get(dev)
                producer = torch.cuda.current_stream(dev)
                if stream is not None and stream != producer:
                    stream.wait_stream(producer)
                    for a in bind:
                        if isinstance(a, torch.Tensor):
                            a.record_stream(stream)
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    q = self._place(buf, p, k,
                                    getattr(exe, "static_input", None))
                    launched.parts.append(
                        _host_copy(exe(q, *args), hosts[k]))
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(dev))
                    launched.done.append(done)
        except BaseException:
            # nothing the launched slices read is released under them
            for ev in launched.done:
                ev.synchronize()
            raise
        return launched

    @staticmethod
    def complete(launched: Launched):
        """The completion half: wait on the launch's own events (batches
        launched after it keep running), copy each slice's outputs out of
        its host set (or read them back, on the synchronous path), join
        the slices in order and slice off the pad lanes as `finalize`
        does."""
        if launched.done:
            for ev in launched.done:
                ev.synchronize()
            parts = [_own(o) for o in launched.parts]
        else:
            parts = [_to_host(o) for o in launched.parts]
        return ShardedDispatcher.finalize(
            _join(parts, launched.instrumented), launched.m,
            instrumented=launched.instrumented)

    @staticmethod
    def finalize(out, m: int, instrumented: bool = False):
        """Slice off the pad lanes of one whole batch's outputs.

        Plain lookups come back as int64 positions.  A scan's ``(pos,
        window)`` comes back as int64 positions and the window decoded to
        uint64 records, ``UINT64_MAX`` past the end.  With
        ``instrumented``, ``out`` is ``(payload, packed stats)``: the
        payload is finalized as above while the packed stats vector, a
        fixed-size device reduction with pad lanes masked out on the
        device, crosses to the host in ONE copy, never sliced.
        """
        if instrumented:
            payload, stats = out
            return (ShardedDispatcher.finalize(payload, m),
                    stats.cpu().numpy())
        if isinstance(out, tuple):
            pos, window = out
            return pos[:m].cpu().numpy(), decode_keys(window[:m])
        return out[:m].cpu().numpy()

    def slice_fns(self, fn, backend: str = "torch") -> Tuple:
        """One lookup callable a slice: a plan compiled for ``backend``
        on each slice's device (`LookupPlan.to`), one callable for every
        slice, or the callables themselves, one a slice."""
        if isinstance(fn, plan_mod.LookupPlan):
            return tuple(fn.to(d).compile(backend=backend)
                         for d in self.devices)
        if callable(fn):
            return (fn,) * self.n_shards
        fns = tuple(fn)
        if len(fns) != self.n_shards:
            raise ValueError(f"{len(fns)} callables for {self.n_shards} "
                             f"slices")
        return fns

    def __call__(self, fn, keys: np.ndarray, backend: str = "torch",
                 n_valid_arg: bool = False):
        """Run a plan (compiled on demand for ``backend``) or lookup
        callables (`slice_fns`) on ``keys``, synchronously: launch every
        slice, then complete.

        ``n_valid_arg=True`` passes each slice's real (pre-pad) key count
        as a second argument: the instrumented-lookup convention.
        """
        fns = self.slice_fns(fn, backend)
        keys = np.asarray(keys, dtype=np.uint64)
        m = keys.size
        with maybe_span(self.recorder, "pad_place", cat="serve",
                        n_keys=int(m)):
            qs, p = self.pad_and_place(keys)
        with maybe_span(self.recorder, "device", cat="serve",
                        padded=int(p), n_shards=self.n_shards):
            valid = self.slice_valid(m, p)
            parts = []
            for k, (f, q) in enumerate(zip(fns, qs)):
                with device_guard(self.devices[k]):
                    parts.append(f(q, valid[k]) if n_valid_arg else f(q))
            return self.complete(Launched(parts=parts, m=m,
                                          instrumented=n_valid_arg))


# ---------------------------------------------------------------------------
# Range-routed dispatch
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RoutedContext:
    """Everything one routed batch pins at dispatch time.

    ``lane_ctxs[s][r]`` is the executor context (read/scan callables +
    cache key) of replica ``r`` of shard ``s``: the executable cache
    keys on ``(shard generation version, replica)``, so each lane has
    its own graphs.  Holding this context holds every lane's shard
    generation (through its callables) and the scan heads of the next
    shards, so a slot that keeps it keeps them alive until it completes.
    Fields are untyped: the executor imports this class, not the other
    way round.
    """

    topology: Any                       # ShardTopology
    lane_ctxs: Tuple[Tuple[Any, ...], ...]
    offsets: Tuple[int, ...]
    versions: Tuple[int, ...]           # per-shard generation versions
    version: int                        # RoutedGeneration version
    instrumented: bool = False

    @property
    def key(self):
        """Executor slot identity: mirrors AsyncContext.key[0]."""
        return (self.version,)


class _RoutedHandle:
    """One launched routed batch: per-shard `Launched` outputs plus the
    inverse permutation that restores admission order at completion.
    ``exes`` holds each touched lane's executable until the batch is
    done."""

    def __init__(self, subs, order, counts, padded, m, kind,
                 instrumented, rctx, exes=()):
        self.subs = subs                # [(shard, Launched), ...]
        self.order = order              # admission index per sorted key
        self.counts = counts            # keys per shard (all shards)
        self.padded = padded            # summed per-shard padded sizes
        self.m = m
        self.kind = kind
        self.instrumented = instrumented
        self.rctx = rctx
        self.exes = tuple(exes)

    def finalize(self):
        """Wait per shard, lift local ranks to global (``+ offsets[s]``),
        and gather through the inverse permutation: results come back in
        exact admission order, which keeps routed completion FIFO per
        request.  Returns ``(result, stats, padded)`` where ``stats`` is
        a list of ``(shard generation version, packed stats)``.
        """
        offs = self.rctx.offsets
        starts = np.zeros(len(self.counts) + 1, dtype=np.int64)
        np.cumsum(self.counts, out=starts[1:])
        pos = np.empty(self.m, dtype=np.int64)
        win = None
        stats = []
        for s, launched in self.subs:
            c = int(self.counts[s])
            fin = ShardedDispatcher.complete(launched)
            if self.instrumented:
                fin, st = fin
                stats.append((self.rctx.versions[s], st))
            idx = self.order[starts[s]:starts[s] + c]
            if isinstance(fin, tuple):        # scan: (pos, window)
                if win is None:
                    win = np.empty((self.m,) + fin[1].shape[1:],
                                   fin[1].dtype)
                pos[idx] = np.asarray(fin[0], dtype=np.int64) + offs[s]
                win[idx] = fin[1]
            else:
                pos[idx] = fin + offs[s]
        if win is not None:
            return (pos, win), stats, self.padded
        return pos, stats, self.padded


class RoutedDispatcher:
    """Scatter/gather dispatch over range-partitioned shard lanes.

    One single-device `ShardedDispatcher` per (shard, replica) lane:
    each lane reuses the broadcast dispatcher's padding, staging and
    placement verbatim, on its own device.  The route step buckets each
    admitted key to its owning shard (host searchsorted at admission, or
    `ShardTopology.route`); per-shard sub-batches launch without
    waiting, and `_RoutedHandle.finalize` gathers them back into
    admission order.  Per-lane work drops from O(batch) to
    O(batch/shards).

    ``devices`` are the cards the lanes are spread over (round robin,
    `shard_replica_groups`; None: every visible card); every shard
    generation a lane runs must have a copy on that lane's device, which
    the registry places on the same groups.  On one card every lane
    shares it.
    """

    def __init__(self, topology, devices=None,
                 pad_quantum: int = PAD_QUANTUM, recorder=None):
        self.pad_quantum = int(pad_quantum)
        self.recorder = recorder
        self._rr_lock = threading.Lock()
        self.lanes_epoch = 0
        self._devices = serving_devices(devices=devices)
        #: the first lane device (the one card the service serves on)
        self.device = self._devices[0]
        self._build_lanes(topology)

    def _build_lanes(self, topology):
        groups = shard_replica_groups(self._devices, topology.replicas)
        self.lanes = tuple(
            tuple(ShardedDispatcher(devices=(dev,),
                                    pad_quantum=self.pad_quantum,
                                    recorder=self.recorder)
                  for dev in grp)
            for grp in groups)
        self._rr = [0] * len(groups)
        self.replicas = tuple(topology.replicas)

    def set_replicas(self, topology) -> bool:
        """Rebuild lanes when the shard/replica layout changes; bumps
        ``lanes_epoch`` so cached lane contexts are re-derived."""
        if (len(self.lanes) == topology.n_shards
                and self.replicas == tuple(topology.replicas)):
            return False
        self._build_lanes(topology)
        self.lanes_epoch += 1
        return True

    @property
    def n_shards(self) -> int:
        return len(self.lanes)

    def padded_size(self, m: int) -> int:
        """Worst-case single-lane bucket for warm planning (actual
        routed padding is per sub-batch)."""
        return self.lanes[0][0].padded_size(m)

    def _pick(self, s: int) -> int:
        """Round-robin read fan-out over shard ``s``'s replicas."""
        with self._rr_lock:
            r = self._rr[s]
            self._rr[s] = (r + 1) % len(self.lanes[s])
        return r

    @property
    def staging_allocs(self) -> int:
        return sum(d.staging_allocs for grp in self.lanes for d in grp)

    @property
    def staging_hits(self) -> int:
        return sum(d.staging_hits for grp in self.lanes for d in grp)

    @staticmethod
    def routes_for(group, topology):
        """Admission-time shard ids for a batch of requests, or None if
        any request missed the route step or was routed against a
        different (hot-swapped) topology: identity, not equality, so a
        republish forces a re-route."""
        sids = []
        for req in group:
            route = getattr(req, "route", None)
            if route is None or route[0] is not topology:
                return None
            sids.append(route[1])
        return np.concatenate(sids) if sids else None

    def launch(self, rctx: RoutedContext, kind: str, aux: int,
               keys: np.ndarray, routes=None, exec_cache=None,
               take_host: Optional[Callable[[], Dict]] = None,
               streams: Optional[Dict] = None) -> _RoutedHandle:
        """Scatter one admitted batch over its shard lanes; returns a
        `_RoutedHandle` (completion is the handle's ``finalize``).

        With ``exec_cache`` (the async path) each touched lane resolves
        its executable through the cache and launches it with
        `ShardedDispatcher.launch` on ``streams[lane device]``, copying
        its outputs into a pinned host set of its own from
        ``take_host()``; without
        it (the sync path) each lane's callable runs on its placed
        sub-batch.  Empty shards launch nothing.  If a lane fails to
        launch, the lanes already launched are waited for before the
        error propagates, so nothing they read is released under them.
        """
        keys = np.asarray(keys, dtype=np.uint64)
        m = keys.size
        topo = rctx.topology
        instr = rctx.instrumented and kind != "scan"
        # one lane layout for the whole batch: `set_replicas` may replace
        # it meanwhile, and the context may predate it; the batch runs on
        # the replicas both layouts hold
        lanes = self.lanes
        with maybe_span(self.recorder, "route", cat="serve",
                        n_keys=int(m), n_shards=len(lanes)):
            sid = routes if routes is not None else topo.route(keys)
            order = np.argsort(sid, kind="stable")
            counts = np.bincount(sid, minlength=len(lanes))
            sorted_keys = keys[order]
        subs, exes = [], []
        padded = 0
        start = 0
        try:
            for s in range(len(lanes)):
                c = int(counts[s])
                if c == 0:
                    continue
                sub = sorted_keys[start:start + c]
                start += c
                r = self._pick(s) % min(len(lanes[s]),
                                        len(rctx.lane_ctxs[s]))
                lane = lanes[s][r]
                ctx = rctx.lane_ctxs[s][r]
                make_fn = ((lambda c=ctx: c.read_fn) if kind != "scan"
                           else (lambda c=ctx, a=aux: c.scan_fn(int(a))))
                if exec_cache is not None:
                    p = lane.padded_size(c)
                    exe = exec_cache.get(ctx, kind, aux, p, make_fn,
                                         lane.device)
                    exes.append(exe)
                    launched = lane.launch((exe,), sub, ((),),
                                           (take_host(),),
                                           instrumented=instr,
                                           streams=streams)
                else:
                    (q,), p = lane.pad_and_place(sub)
                    with device_guard(lane.device):
                        out = make_fn()(q, c) if instr else make_fn()(q)
                    launched = Launched(parts=[out], m=c,
                                        instrumented=instr)
                padded += p
                subs.append((s, launched))
        except BaseException:
            for _, launched in subs:
                for ev in launched.done:
                    ev.synchronize()
            raise
        return _RoutedHandle(subs, order, counts, padded, m, kind,
                             instr, rctx, exes)

    def __call__(self, rctx: RoutedContext, kind: str, aux: int,
                 keys: np.ndarray, routes=None):
        """Synchronous routed dispatch: launch then finalize."""
        return self.launch(rctx, kind, aux, keys, routes=routes).finalize()
