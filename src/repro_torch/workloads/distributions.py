"""Key-access distributions as *rank samplers* (numpy copy of the
reference's `repro.workloads.distributions`, bit for bit per seed).

A sampler maps ``(rng, size, n_keys)`` to int64 ranks in ``[0, n_keys)``
— which key of the sorted key array each operation touches.  Ranks, not
keys: the same access pattern then composes with any dataset, and a
"hot" rank set stays hot across a compaction that changes key values.

All samplers draw from the caller's `np.random.Generator` in a fixed
order, so a `Workload` is fully determined by its seed (the
reproducibility contract `make_workload` documents).
"""
from __future__ import annotations

import numpy as np

__all__ = ["DISTRIBUTIONS", "uniform_ranks", "zipfian_ranks",
           "hot_set_ranks", "sequential_ranks"]


def uniform_ranks(rng: np.random.Generator, size: int, n_keys: int) -> np.ndarray:
    """Every key equally likely — the paper's own sampling regime."""
    return rng.integers(0, n_keys, size=size, dtype=np.int64)


def zipfian_ranks(rng: np.random.Generator, size: int, n_keys: int,
                  theta: float = 0.99, scramble: bool = True) -> np.ndarray:
    """Bounded zipfian over ranks (YCSB's default skew, theta=0.99).

    Inverse-CDF sampling over the explicit rank weights ``(i+1)^-theta``;
    ``scramble`` applies a seeded permutation so the popular keys are
    spread over the key space instead of clustering at the low end
    (YCSB's "scrambled zipfian" — without it, skew and key locality
    are conflated and a learned index sees an unrealistically easy
    hot range).
    """
    w = np.power(np.arange(1, n_keys + 1, dtype=np.float64), -float(theta))
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    ranks = np.searchsorted(cdf, rng.random(size), side="left").astype(np.int64)
    ranks = np.minimum(ranks, n_keys - 1)
    if scramble:
        ranks = rng.permutation(n_keys)[ranks]
    return ranks


def hot_set_ranks(rng: np.random.Generator, size: int, n_keys: int,
                  hot_frac: float = 0.01, hot_weight: float = 0.9) -> np.ndarray:
    """A random ``hot_frac`` of the keys receives ``hot_weight`` of the
    accesses, uniform within each class — the two-temperature caricature
    of production key popularity."""
    n_hot = int(np.clip(round(n_keys * hot_frac), 1, n_keys))
    perm = rng.permutation(n_keys)
    hot, cold = perm[:n_hot], perm[n_hot:]
    pick_hot = rng.random(size) < hot_weight if len(cold) else np.ones(size, bool)
    hot_draw = hot[rng.integers(0, n_hot, size=size)]
    cold_draw = (cold[rng.integers(0, len(cold), size=size)]
                 if len(cold) else hot_draw)
    return np.where(pick_hot, hot_draw, cold_draw).astype(np.int64)


def sequential_ranks(rng: np.random.Generator, size: int, n_keys: int,
                     stride: int = 1) -> np.ndarray:
    """A scan from a random start, wrapping — the pattern that makes
    range-friendly structures shine and hashing baselines collapse."""
    start = int(rng.integers(0, n_keys))
    return (start + np.arange(size, dtype=np.int64) * int(stride)) % n_keys


DISTRIBUTIONS = {
    "uniform": uniform_ranks,
    "zipfian": zipfian_ranks,
    "hot_set": hot_set_ranks,
    "sequential": sequential_ranks,
}
