"""Seeded point-query batches (numpy copy of the reference's generator)."""
from __future__ import annotations

import numpy as np

from repro_torch.workloads.distributions import DISTRIBUTIONS

__all__ = ["make_point_queries"]


def make_point_queries(keys: np.ndarray, m: int, seed: int = 0,
                       present_frac: float = 0.8, dist: str = "uniform",
                       **dist_kw) -> np.ndarray:
    """Seeded point-query batch: ``present_frac`` sampled present keys
    (via the ``dist`` rank sampler) + uniform absent draws, shuffled."""
    keys = np.asarray(keys, dtype=np.uint64)
    rng = np.random.default_rng(seed)
    n_present = int(m * present_frac)
    present = keys[DISTRIBUTIONS[dist](rng, n_present, keys.size, **dist_kw)]
    lo, hi = int(keys[0]), int(keys[-1])
    # the min() clamp keeps the upper bound within uint64
    absent = rng.integers(max(lo - 1000, 0), min(hi + 1000, 1 << 64),
                          size=m - n_present, dtype=np.uint64)
    q = np.concatenate([present, absent])
    rng.shuffle(q)
    return q.astype(np.uint64)
