"""Dispatch: one plan-compiled lookup over a padded query batch.

A batch of uint64 request keys is padded to a power-of-two bucket,
encoded (`kernels.common` codec) into a pinned host staging buffer of
that bucket, copied to the device without blocking, and run through a
`repro_torch.core.plan.LookupPlan` callable: pass a plan and the
dispatcher compiles (and caches) the lookup for the requested backend,
or pass any lookup callable (a scan or instrumented lookup) directly.
The bucket bounds the distinct batch shapes at log2(max batch).  Pad
lanes repeat the first real key and are sliced off at completion.

This is the reference's `repro.serve.lookup.dispatch.ShardedDispatcher`
on ONE device: ``n_shards`` is 1 and there is no mesh.  Range-routed
dispatch (`RoutedDispatcher`) runs one such dispatcher per (shard,
replica) lane; on one card every lane shares it, each with its own
staging buffers and copy events.

Staging reuse: the host-to-device copy of a pinned buffer is
asynchronous, and the next batch of the same bucket pads into the same
buffer.  Returning while the copy is in flight would let that pad
overwrite this batch's queries (the race the reference fixed by
blocking on its placement).  So a CUDA event is recorded after each
copy, and the next write into that bucket's buffer waits on it.  On the
CPU the placement is a copy, so the staging buffer never aliases a
batch either.

Two faces.  The synchronous `__call__` launches and then `finalize`s
(reads the results back with ``.cpu()``, which waits for the stream).
The async executor uses the split halves instead: `launch` stages the
batch, copies it to the device (straight into a captured graph's static
input when the executable has one), runs the executable, and enqueues a
``non_blocking`` copy of every output into pinned host buffers that
belong to the launching slot, followed by an event, all on the
executor's stream; `complete` waits on that one event and copies the
outputs out of the slot's buffers (a result outlives the slot, whose
buffers a later launch reuses).  Waiting on
the launch's own event (never ``.cpu()``) leaves the batches launched
after it running, and copying the outputs right after the replay, in
stream order, keeps them safe from the next replay of the same graph,
which rewrites its static outputs.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import plan as plan_mod
from repro_torch.kernels.common import SIGN_BIT, decode_keys, resolve_device
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


@dataclasses.dataclass
class Launched:
    """One batch launched by `ShardedDispatcher.launch`: its outputs (host
    copies in flight on a CUDA device, the outputs themselves on the CPU)
    and the event recorded after the copies."""

    out: Any
    m: int
    instrumented: bool = False
    done: Optional[Any] = None     # torch.cuda.Event, None on the CPU


class ShardedDispatcher:
    """Pads, stages, places and runs query batches on one device."""

    def __init__(self, device=None, pad_quantum: int = PAD_QUANTUM,
                 recorder=None):
        self.device = resolve_device(device)
        self.pad_quantum = int(pad_quantum)
        self.n_shards = 1
        #: optional `repro_torch.obs.trace.SpanRecorder`: the dispatch
        #: path splits into a pad+place span (host-side data movement)
        #: and a device span (launch + wait), so a slow batch names which
        #: half it spent its time in.
        self.recorder = recorder
        # one staging buffer per pow2 bucket (pinned on a CUDA device),
        # and the event recorded after the last copy out of it
        self._staging: Dict[int, torch.Tensor] = {}
        self._copied: Dict[int, torch.cuda.Event] = {}
        self.staging_hits = 0
        self.staging_allocs = 0

    def padded_size(self, m: int) -> int:
        """The smallest ``pad_quantum * 2^k`` that holds ``m`` keys."""
        p = self.pad_quantum
        while p < m:
            p <<= 1
        return p

    def _stage(self, keys: np.ndarray):
        """Pad ``keys`` to their pow2 bucket and encode them into the
        bucket's staging buffer; returns ``(buffer, padded size)``."""
        m = keys.size
        p = self.padded_size(m)
        buf = self._staging.get(p)
        if buf is None:
            buf = torch.empty(p, dtype=torch.int64,
                              pin_memory=self.device.type == "cuda")
            self._staging[p] = buf
            self.staging_allocs += 1
        else:
            self.staging_hits += 1
            copied = self._copied.get(p)
            if copied is not None:
                # the last copy out of buf is done
                with maybe_span(self.recorder, "stage_wait", cat="serve",
                                padded=int(p)):
                    copied.synchronize()
        host = buf.numpy().view(np.uint64)
        np.bitwise_xor(keys, np.uint64(SIGN_BIT), out=host[:m])
        host[m:] = host[0]       # any valid key: lanes are independent
        return buf, p

    def _copy_out(self, buf, p: int, dst=None):
        """Copy staging buffer ``buf`` to the device (into ``dst`` when
        given) on the current stream and record the event the buffer's
        next write waits on; returns the device batch."""
        if dst is None:
            dst = buf.to(self.device, non_blocking=True)
        else:
            dst.copy_(buf, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(self.device))
        self._copied[p] = copied
        return dst

    def pad_and_place(self, keys: np.ndarray):
        """Pad to the pow2 bucket, encode into the bucket's staging
        buffer and place on the device; returns ``(device batch of
        encoded keys, padded size)``."""
        buf, p = self._stage(np.asarray(keys, dtype=np.uint64))
        if self.device.type != "cuda":
            return buf.clone(), p
        return self._copy_out(buf, p), p

    def launch(self, exe, keys: np.ndarray, args, host: Dict,
               instrumented: bool = False, stream=None):
        """The launch half of async dispatch: stage, place, run ``exe(q,
        *args)`` and enqueue the copy of its outputs into the pinned
        buffers of ``host`` (the launching slot's own set, made on first
        use), all on ``stream`` (the executor's own; None: the current
        stream), without waiting on the device.  An ``exe`` with a
        ``static_input`` (a captured graph) gets the batch copied
        straight into it.  ``instrumented`` says the outputs are
        ``(payload, packed stats)``.  Returns a `Launched` for
        `complete`.

        Device operands in ``args`` (a padded delta) were made on the
        caller's stream: ``stream`` first waits for everything queued on
        it, and each operand is marked as used on ``stream``, so the
        caching allocator does not hand its memory out again before this
        launch has read it."""
        keys = np.asarray(keys, dtype=np.uint64)
        buf, p = self._stage(keys)
        if self.device.type != "cuda":
            return Launched(out=exe(buf.clone(), *args), m=keys.size,
                            instrumented=instrumented)
        producer = torch.cuda.current_stream(self.device)
        if stream is not None and stream != producer:
            stream.wait_stream(producer)
            for a in args:
                if isinstance(a, torch.Tensor):
                    a.record_stream(stream)
        with torch.cuda.stream(stream):          # None: the current one
            q = self._copy_out(buf, p, getattr(exe, "static_input", None))
            out = _host_copy(exe(q, *args), host)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return Launched(out=out, m=keys.size, instrumented=instrumented,
                        done=done)

    @staticmethod
    def complete(launched: Launched):
        """The completion half: wait on the launch's own event (batches
        launched after it keep running), copy its outputs out of the
        slot's pinned buffers, and slice them as `finalize` slices."""
        out = launched.out
        if launched.done is not None:
            launched.done.synchronize()
            out = _own(out)
        return ShardedDispatcher.finalize(out, launched.m,
                                          instrumented=launched.instrumented)

    @staticmethod
    def finalize(out, m: int, instrumented: bool = False):
        """Wait for a launched computation and slice off the pad lanes:
        the completion half of dispatch, and the only point that waits
        on the device.

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

    def __call__(self, fn, keys: np.ndarray, backend: str = "torch",
                 n_valid_arg: bool = False):
        """Run a plan (compiled on demand for ``backend``) or any lookup
        callable on ``keys``, synchronously: launch then finalize.

        ``n_valid_arg=True`` passes the real (pre-pad) batch size as a
        second argument: the instrumented-lookup convention.
        """
        if isinstance(fn, plan_mod.LookupPlan):
            fn = fn.compile(backend=backend)
        keys = np.asarray(keys, dtype=np.uint64)
        with maybe_span(self.recorder, "pad_place", cat="serve",
                        n_keys=int(keys.size)):
            q, p = self.pad_and_place(keys)
        with maybe_span(self.recorder, "device", cat="serve",
                        padded=int(p), n_shards=self.n_shards):
            out = fn(q, int(keys.size)) if n_valid_arg else fn(q)
            return self.finalize(out, keys.size, instrumented=n_valid_arg)


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
    `shard_replica_groups`); every shard generation a lane runs must
    live on that lane's device.  The service builds every shard on its
    one device and passes only that device, so on one card every lane
    shares it.
    """

    def __init__(self, topology, devices=None,
                 pad_quantum: int = PAD_QUANTUM, recorder=None):
        self.pad_quantum = int(pad_quantum)
        self.recorder = recorder
        self._rr_lock = threading.Lock()
        self.lanes_epoch = 0
        self._devices = ([resolve_device(None)] if devices is None
                         else [torch.device(d) for d in devices])
        #: the first lane device (the one card the service serves on)
        self.device = self._devices[0]
        self._build_lanes(topology)

    def _build_lanes(self, topology):
        groups = shard_replica_groups(self._devices, topology.replicas)
        self.lanes = tuple(
            tuple(ShardedDispatcher(device=dev,
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
               stream=None) -> _RoutedHandle:
        """Scatter one admitted batch over its shard lanes; returns a
        `_RoutedHandle` (completion is the handle's ``finalize``).

        With ``exec_cache`` (the async path) each touched lane resolves
        its executable through the cache and launches it with
        `ShardedDispatcher.launch` on ``stream``, copying its outputs
        into a pinned host set of its own from ``take_host()``; without
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
                args = (c,) if instr else ()
                if exec_cache is not None:
                    p = lane.padded_size(c)
                    exe = exec_cache.get(ctx, kind, aux, p, make_fn, lane)
                    exes.append(exe)
                    launched = lane.launch(exe, sub, args, host=take_host(),
                                           instrumented=instr, stream=stream)
                else:
                    q, p = lane.pad_and_place(sub)
                    launched = Launched(out=make_fn()(q, *args), m=c,
                                        instrumented=instr)
                padded += p
                subs.append((s, launched))
        except BaseException:
            for _, launched in subs:
                if launched.done is not None:
                    launched.done.synchronize()
            raise
        return _RoutedHandle(subs, order, counts, padded, m, kind,
                             instr, rctx, exes)

    def __call__(self, rctx: RoutedContext, kind: str, aux: int,
                 keys: np.ndarray, routes=None):
        """Synchronous routed dispatch: launch then finalize."""
        return self.launch(rctx, kind, aux, keys, routes=routes).finalize()
