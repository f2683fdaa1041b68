"""Key-access distributions as *rank samplers* (numpy copy of the reference).

A sampler maps ``(rng, size, n_keys)`` to int64 ranks in ``[0, n_keys)``
and draws from the caller's `np.random.Generator` in a fixed order, so the
same seed gives the reference's stream bit for bit.
"""
from __future__ import annotations

import numpy as np

__all__ = ["DISTRIBUTIONS", "uniform_ranks"]


def uniform_ranks(rng: np.random.Generator, size: int, n_keys: int) -> np.ndarray:
    """Every key equally likely — the paper's own sampling regime."""
    return rng.integers(0, n_keys, size=size, dtype=np.int64)


DISTRIBUTIONS = {
    "uniform": uniform_ranks,
}
