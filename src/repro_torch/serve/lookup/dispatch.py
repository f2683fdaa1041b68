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
on ONE device: ``n_shards`` is 1 and there is no mesh (range-routed
dispatch over several cards is a later port).

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
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import plan as plan_mod
from repro_torch.kernels.common import SIGN_BIT, decode_keys, resolve_device
from repro_torch.obs.trace import maybe_span

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
