"""Sorted delta buffer: the write side of a mutable learned index.

A `DeltaBuffer` is an immutable snapshot of the keys inserted since the
base index was last built: sorted, unique, and disjoint from the base
key set (set semantics: re-inserting a present key is a no-op).  Every
mutation returns a NEW buffer, so a reader that grabbed a snapshot keeps
a consistent view while writers race ahead.

The device form holds the sorted keys encoded (`kernels.common` codec),
padded to a power-of-two bucket with ``INT64_MAX``, the code of the
reference's ``UINT64_MAX`` pad.  Lower-bound semantics make that pad
exact: ``LB_delta(q)`` counts delta keys ``< q``, and no query is ever
above ``INT64_MAX``, so pad lanes are never counted.  A service over
several cards reads the copy on each card (`DeltaBuffer.on`), made from
the first at first use and kept with the snapshot.  A *real* key
``2^64 - 1`` encodes to the sentinel itself and is still counted
correctly for the same reason; it lives in ``keys_np`` and survives
compaction like any other key.  Pow-2 padding bounds the distinct delta
shapes at O(log max_delta), mirroring the dispatcher's query buckets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import encode_keys, resolve_device

__all__ = ["UINT64_MAX", "DeltaBuffer"]

UINT64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)

#: Smallest device pad: matches the dispatcher's 128-lane quantum.
PAD_QUANTUM = 128


def _pad_size(n: int, quantum: int = PAD_QUANTUM) -> int:
    p = quantum
    while p < n:
        p <<= 1
    return p


def _membership(sorted_arr: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Vectorized `k in sorted_arr` (both uint64, arr sorted unique)."""
    if sorted_arr.size == 0:
        return np.zeros(k.shape, dtype=bool)
    p = np.searchsorted(sorted_arr, k, side="left")
    return (p < sorted_arr.size) & (sorted_arr[np.minimum(p, sorted_arr.size - 1)] == k)


@dataclasses.dataclass(frozen=True)
class DeltaBuffer:
    """Immutable sorted-unique delta snapshot + its padded device copy."""

    keys_np: np.ndarray        # sorted unique uint64, disjoint from base
    device: torch.Tensor       # encoded int64, pow2-padded with INT64_MAX
    pad_quantum: int = PAD_QUANTUM
    #: device -> the padded copy there (`on`)
    _copies: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def count(self) -> int:
        return int(self.keys_np.size)

    def on(self, device) -> torch.Tensor:
        """The padded device copy on ``device``: ``device`` itself where
        it lies, else a copy of it made there at first use and kept."""
        device = torch.device(device)
        if device == self.device.device:
            return self.device
        t = self._copies.get(device)
        if t is None:
            t = self._copies[device] = self.device.to(device)
        return t

    @staticmethod
    def _to_device(keys_np: np.ndarray, quantum: int, device):
        padded = np.full(_pad_size(keys_np.size, quantum), UINT64_MAX,
                         dtype=np.uint64)
        padded[:keys_np.size] = keys_np
        return encode_keys(padded, device)

    def _with_keys(self, keys_np: np.ndarray) -> "DeltaBuffer":
        return DeltaBuffer(keys_np=keys_np,
                           device=self._to_device(keys_np, self.pad_quantum,
                                                  self.device.device),
                           pad_quantum=self.pad_quantum)

    @classmethod
    def empty(cls, pad_quantum: int = PAD_QUANTUM,
              device=None) -> "DeltaBuffer":
        """An empty delta on ``device`` (None: the CUDA card)."""
        keys = np.empty(0, dtype=np.uint64)
        return cls(keys_np=keys,
                   device=cls._to_device(keys, pad_quantum,
                                         resolve_device(device)),
                   pad_quantum=pad_quantum)

    def with_inserted(self, base_np: np.ndarray,
                      k: np.ndarray) -> Tuple["DeltaBuffer", np.ndarray]:
        """Admit new keys (dedup vs base, this delta, and within-batch:
        first occurrence wins).  Returns (new buffer, 0/1 admitted flag
        per input key)."""
        k = np.asarray(k, dtype=np.uint64).ravel()
        fresh = ~(_membership(base_np, k) | _membership(self.keys_np, k))
        admitted = fresh.copy()
        if fresh.any():
            idx = np.flatnonzero(fresh)
            uniq, first = np.unique(k[idx], return_index=True)
            keep = np.zeros(idx.size, dtype=bool)
            keep[first] = True
            admitted[idx[~keep]] = False
            merged = np.empty(self.keys_np.size + uniq.size, dtype=np.uint64)
            pos = np.searchsorted(self.keys_np, uniq, side="left")
            # stable two-way merge of two disjoint sorted arrays
            new_slots = pos + np.arange(uniq.size)
            mask = np.zeros(merged.size, dtype=bool)
            mask[new_slots] = True
            merged[mask] = uniq
            merged[~mask] = self.keys_np
            new = self._with_keys(merged)
        else:
            new = self
        return new, admitted.astype(np.int64)

    def minus(self, snapshot: "DeltaBuffer") -> "DeltaBuffer":
        """Drop every key present in ``snapshot`` (the subset a finished
        compaction folded into the new base); keeps keys admitted after
        the snapshot was taken."""
        if snapshot.count == 0:
            return self
        return self._with_keys(
            self.keys_np[~_membership(snapshot.keys_np, self.keys_np)])
