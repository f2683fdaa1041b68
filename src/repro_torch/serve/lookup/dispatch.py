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
"""
from __future__ import annotations

from typing import Dict

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

    def pad_and_place(self, keys: np.ndarray):
        """Pad to the pow2 bucket, encode into the bucket's staging
        buffer and place on the device; returns ``(device batch of
        encoded keys, padded size)``, the launch half of dispatch."""
        keys = np.asarray(keys, dtype=np.uint64)
        m = keys.size
        p = self.padded_size(m)
        cuda = self.device.type == "cuda"
        buf = self._staging.get(p)
        if buf is None:
            buf = torch.empty(p, dtype=torch.int64, pin_memory=cuda)
            self._staging[p] = buf
            self.staging_allocs += 1
        else:
            self.staging_hits += 1
            copied = self._copied.get(p)
            if copied is not None:
                copied.synchronize()   # the last copy out of buf is done
        host = buf.numpy().view(np.uint64)
        np.bitwise_xor(keys, np.uint64(SIGN_BIT), out=host[:m])
        host[m:] = host[0]       # any valid key: lanes are independent
        if not cuda:
            return buf.clone(), p
        q = buf.to(self.device, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(self.device))
        self._copied[p] = copied
        return q, p

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
