"""Range-partitioned serving topology.

A ``ShardTopology`` splits the sorted key space into contiguous ranges.
Shard ``s`` owns the half-open key interval

    (split_points[s-1], split_points[s]]        (uint64, inclusive right)

so a query ``q`` routes to ``searchsorted(split_points, q, side='left')``:
queries below the global minimum land in shard 0, queries above the global
maximum land in the last shard, and a query exactly equal to a split point
routes to the shard that *owns* that key (``side='left'`` is load-bearing:
``split_points[s]`` IS shard ``s``'s last key, and its lower-bound rank —
the first occurrence of that key — lives inside shard ``s``).  Boundaries are snapped left to
the first occurrence of the boundary key, so every duplicate of a split
key lives entirely inside one shard — that is what makes the routed
lower-bound rank ``offsets[s] + LB_local(q)`` bit-identical to the global
``LB(q)`` even for duplicated keys.

The topology is a value object carried by registry generations; the
dispatcher, health monitor, and metrics all consume it read-only.

A copy of the reference's `repro.serve.lookup.topology`;
`shard_replica_groups` lives in `repro_torch.dist.sharding`, as the
reference's does, and is imported here under its name.  Split points
stay raw uint64 on the host; `route_device` compares them in the key
codec of `repro_torch.kernels.common` (flipped int64) on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dist.sharding import shard_replica_groups  # noqa: F401
from repro_torch.kernels.common import branchless_lower_bound, encode_keys


@dataclasses.dataclass(frozen=True, eq=False)
class ShardTopology:
    """Contiguous range partition of a sorted uint64 key space.

    ``split_points`` has ``n_shards - 1`` entries: ``split_points[s]`` is
    the last key owned by shard ``s`` (i.e. ``keys[offsets[s+1] - 1]``).
    ``offsets`` has ``n_shards + 1`` entries into the global sorted array.
    ``replicas[s]`` is the read fan-out of shard ``s`` (>= 1).
    """

    split_points: np.ndarray           # uint64[S-1]
    offsets: Tuple[int, ...]           # len S+1, offsets[0] == 0
    replicas: Tuple[int, ...]          # len S, each >= 1
    n_keys: int
    _dev_splits: dict = dataclasses.field(default_factory=dict, repr=False)

    # -- construction ----------------------------------------------------
    @classmethod
    def from_keys(cls, keys, n_shards: int,
                  replicas: int | Sequence[int] = 1) -> "ShardTopology":
        """Equal-count range partition of a *sorted* uint64 key array.

        Raw equal-count boundaries are snapped left to the first
        occurrence of the boundary key so duplicates never straddle a
        split; collapsed boundaries are deduped, so the effective shard
        count can be smaller than requested on heavily-duplicated data.
        """
        keys = np.asarray(keys)
        n = int(keys.size)
        if n == 0:
            raise ValueError("cannot build a topology over zero keys")
        n_shards = int(n_shards)
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        n_shards = min(n_shards, n)
        raw = [round(s * n / n_shards) for s in range(1, n_shards)]
        offs = [0]
        for off in raw:
            # Snap left so every duplicate of the boundary key lands in
            # the *later* shard (routing sends q == split to the earlier
            # shard, which then owns the full duplicate run's LB rank).
            snapped = int(np.searchsorted(keys, keys[off], side="left"))
            if snapped > offs[-1]:
                offs.append(snapped)
        offs.append(n)
        splits = np.asarray([keys[o - 1] for o in offs[1:-1]],
                            dtype=np.uint64)
        s_eff = len(offs) - 1
        if isinstance(replicas, int):
            reps = (int(replicas),) * s_eff
        else:
            reps = tuple(int(r) for r in replicas)[:s_eff]
            reps = reps + (1,) * (s_eff - len(reps))
        if any(r < 1 for r in reps):
            raise ValueError("every shard needs at least one replica")
        return cls(split_points=splits, offsets=tuple(offs),
                   replicas=reps, n_keys=n)

    @classmethod
    def single(cls, n_keys: int) -> "ShardTopology":
        """Degenerate one-shard topology (routes everything to shard 0)."""
        return cls(split_points=np.empty(0, dtype=np.uint64),
                   offsets=(0, int(n_keys)), replicas=(1,),
                   n_keys=int(n_keys))

    # -- shape -----------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self.offsets) - 1

    @property
    def shard_sizes(self) -> Tuple[int, ...]:
        return tuple(self.offsets[s + 1] - self.offsets[s]
                     for s in range(self.n_shards))

    @property
    def min_shard_len(self) -> int:
        return min(self.shard_sizes)

    # -- routing ---------------------------------------------------------
    def route(self, keys) -> np.ndarray:
        """Host-side shard id per key (int64), admission-time path."""
        if self.n_shards == 1:
            return np.zeros(np.asarray(keys).shape, dtype=np.int64)
        return np.searchsorted(self.split_points,
                               np.asarray(keys, dtype=np.uint64),
                               side="left").astype(np.int64)

    def route_device(self, q):
        """Device-side shard id per key via the branchless lower bound.

        ``q`` holds encoded keys (int64, sign bit flipped); the split
        points are encoded the same way, once per device, so the int64
        comparison is the uint64 one.  Same primitive the lookup kernels
        use (``side='left'`` = first split >= q, so a query equal to a
        split routes to the shard that owns it); int32 shard ids.
        """
        if self.n_shards == 1:
            return torch.zeros(q.shape, dtype=torch.int32, device=q.device)
        key = str(q.device)
        splits = self._dev_splits.get(key)
        if splits is None:
            splits = encode_keys(self.split_points, q.device)
            self._dev_splits[key] = splits
        m = int(splits.shape[0])
        lo = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
        hi = torch.full(q.shape, m - 1, dtype=torch.int32, device=q.device)
        return branchless_lower_bound(splits, q, lo, hi, max_width=m,
                                      side="left",
                                      index_dtype=torch.int32)

    # -- replica policy --------------------------------------------------
    def rebalanced(self, traffic_hist,
                   total_replicas: Optional[int] = None) -> "ShardTopology":
        """New topology with replicas re-apportioned to observed traffic.

        ``traffic_hist`` is the health layer's key-space traffic
        histogram: counts over equal-width *rank* buckets of the global
        key space.  Each
        bucket's mass is prorated onto the shard rank ranges it overlaps;
        replica seats are then assigned largest-remainder with a floor of
        one per shard, holding the total seat count fixed (or growing it
        to ``total_replicas``).
        """
        hist = np.asarray(traffic_hist, dtype=np.float64)
        total = int(total_replicas if total_replicas is not None
                    else sum(self.replicas))
        s_eff = self.n_shards
        total = max(total, s_eff)
        if hist.size == 0 or hist.sum() <= 0:
            share = np.full(s_eff, 1.0 / s_eff)
        else:
            edges = np.linspace(0, self.n_keys, hist.size + 1)
            share = np.zeros(s_eff)
            for s in range(s_eff):
                lo, hi = self.offsets[s], self.offsets[s + 1]
                # fraction of each rank bucket inside [lo, hi)
                overlap = (np.minimum(edges[1:], hi)
                           - np.maximum(edges[:-1], lo))
                frac = np.clip(overlap, 0.0, None) / np.maximum(
                    edges[1:] - edges[:-1], 1e-9)
                share[s] = float((hist * frac).sum())
            share = share / share.sum() if share.sum() > 0 else np.full(
                s_eff, 1.0 / s_eff)
        return self._apportion(share, total)

    def rebalanced_from_masses(self, masses,
                               total_replicas: Optional[int] = None
                               ) -> "ShardTopology":
        """Same policy, driven by per-shard traffic masses directly
        (what the service reads off each shard's health record)."""
        masses = np.asarray(masses, dtype=np.float64)
        total = int(total_replicas if total_replicas is not None
                    else sum(self.replicas))
        s_eff = self.n_shards
        total = max(total, s_eff)
        share = (masses / masses.sum() if masses.sum() > 0
                 else np.full(s_eff, 1.0 / s_eff))
        return self._apportion(share, total)

    def _apportion(self, share: np.ndarray, total: int) -> "ShardTopology":
        s_eff = self.n_shards
        quota = share * (total - s_eff)   # floor of 1 seat each, then LR
        reps = np.ones(s_eff, dtype=np.int64) + np.floor(quota).astype(
            np.int64)
        rem = quota - np.floor(quota)
        for s in np.argsort(-rem)[: total - int(reps.sum())]:
            reps[s] += 1
        return ShardTopology(split_points=self.split_points,
                             offsets=self.offsets,
                             replicas=tuple(int(r) for r in reps),
                             n_keys=self.n_keys)

    def describe(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "n_keys": self.n_keys,
            "shard_sizes": list(self.shard_sizes),
            "replicas": list(self.replicas),
            "split_points": [int(s) for s in self.split_points],
        }

