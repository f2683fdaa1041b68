"""Robin Hood hash table (paper §4.1.1 hashing baseline, point lookups only).

Robin Hood with linear probing stores keys sorted by home slot, which lets
the whole layout be computed vectorized at build time (``pos_i =
max(home_i, pos_{i-1} + 1)`` is a running max); the layout is the
reference's host numpy.  A lookup gathers a probe window of the largest
displacement + 1 slots and resolves membership with one vector compare,
no probe loop.  No lower-bound or range support: a point-only plan.

The hash is multiply-shift on the ORIGINAL uint64 key: the encoded query
with its sign bit flipped back, multiplied as wrapping int64 (the same
low 64 bits as the uint64 product), then shifted right logically.  Slot
keys are held encoded, an empty slot as ``INT64_MAX`` (the code of the
reference's ``UINT64_MAX``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import base, spec
from repro_torch.kernels.common import encode_keys, resolve_device

spec.register_schema(
    "robin_hash",
    fields=[spec.HyperField("load_factor", float, 0.5, lo=0.05, hi=0.95)],
    # smallest -> largest size: higher load factor = denser table
    ladder=[dict(load_factor=f) for f in (0.8, 0.5, 0.25)],
    sweep=False,
    sweep_exclude_reason=(
        "point-only: no lower-bound semantics, so it has no place on the "
        "size x LB-latency Pareto sweep (paper §4.1.1); benchmarks time it "
        "separately as the Table 2 hash companion"),
)

_MULT = 0x9E3779B97F4A7C15
#: `_MULT` as a two's-complement int64
_MULT_I64 = _MULT - (1 << 64)
_INT64_MIN = -(1 << 63)


def _hash_np(k: np.ndarray, bits: int) -> np.ndarray:
    """Home slots of uint64 keys (numpy, wrapping)."""
    with np.errstate(over="ignore"):
        return (k * np.uint64(_MULT)) >> np.uint64(64 - bits)


def hash_slots(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Home slots of encoded keys: `_hash_np` of the uint64 keys."""
    k = q ^ _INT64_MIN                         # the uint64 key's bit pattern
    return ((k * _MULT_I64) >> (64 - bits)) & ((1 << bits) - 1)


def table_bits(n: int, load_factor: float) -> int:
    return max(1, int(np.ceil(np.log2(max(2, n / load_factor)))))


def _assemble(n: int, slot_key: np.ndarray, slot_val: np.ndarray,
              load_factor: float, W: int, dev) -> base.IndexBuild:
    """``slot_key`` uint64 (``UINT64_MAX`` empty), ``slot_val`` int64."""
    bits = table_bits(n, load_factor)
    table_len = len(slot_key)
    state = {"slot_key": encode_keys(slot_key, dev),
             "slot_val": torch.from_numpy(
                 np.array(slot_val, np.int64)).to(dev)}

    def lookup(state, q):
        """Point lookup: ``(found[B] bool, position[B] int64)``."""
        home = hash_slots(q, bits)
        idx = home[:, None] + torch.arange(W, dtype=torch.int64,
                                           device=q.device)[None, :]
        idx = torch.clamp(idx, 0, table_len - 1)
        hit = state["slot_key"][idx] == q[:, None]
        found = hit.any(dim=-1)
        first = hit.to(torch.uint8).argmax(dim=-1)
        val = state["slot_val"][idx.gather(1, first[:, None])[:, 0]]
        return found, torch.where(found, val, -1)

    return base.IndexBuild(
        name="robin_hash",
        state=state,
        lookup=lookup,
        size_bytes=base.nbytes(slot_key, slot_val),
        hyper=dict(load_factor=load_factor, probe_window=W),
        meta={"max_err": 0, "levels": 1, "n": n, "point_only": True},
    )


@base.register("robin_hash")
def build(keys: np.ndarray, load_factor: float = 0.5, device=None,
          **_) -> base.IndexBuild:
    """The Robin Hood layout of uint64 ``keys`` (host numpy), on
    ``device`` (None: the CUDA card)."""
    dev = resolve_device(device)
    keys = np.asarray(keys).astype(np.uint64)
    n = len(keys)
    bits = table_bits(n, load_factor)
    if bits + n.bit_length() > 62:
        raise ValueError(f"robin_hash: {n} keys need 2^{bits} slots")
    # keys in order of (home slot, position): the reference's stable
    # argsort by home, as one sort of distinct packed int64 values
    packed = _hash_np(keys, bits).astype(np.int64) * n + np.arange(n)
    packed.sort()
    home_s, order = np.divmod(packed, n)
    del packed
    # Robin Hood layout: pos_i = max(home_i, pos_{i-1} + 1), vectorized.
    ar = np.arange(n)
    pos = np.maximum.accumulate(home_s - ar) + ar
    del ar
    max_disp = int((pos - home_s).max())
    del home_s
    table_len = int(pos[-1]) + 1
    slot_key = np.full(table_len, np.iinfo(np.uint64).max, np.uint64)
    slot_val = np.full(table_len, -1, np.int64)  # payload = position in D
    slot_key[pos] = keys[order]
    slot_val[pos] = order
    return _assemble(n, slot_key, slot_val, load_factor, max_disp + 1, dev)
