"""What every dataset generator shares: sorting, deduplication and
cutting to exactly ``n`` keys, on the device, from one generator.

A generator under ``datagen/`` is a module with ``generate(n, gen,
device)`` returning ``n`` sorted unique int64 keys in ``[0, 2^63)``; the
configuration names it by its file name (``"dataset"``), and `load`
finds it.  A generator draws more than ``n`` keys from its distribution
and `finalize` keeps a uniform choice of ``n`` of the distinct ones, so
every key comes from the stated distribution: nothing is topped up from
another.
"""
from __future__ import annotations

from pathlib import Path

import torch

from lookup_bench import load_file

DATAGEN = Path(__file__).resolve().parent / "datagen"


def load(name: str):
    """The generator module ``datagen/<name>.py``."""
    return load_file(DATAGEN / f"{name}.py")


def sorted_unique(raw: torch.Tensor) -> torch.Tensor:
    """The distinct values of an int64 tensor, ascending."""
    return torch.unique_consecutive(torch.sort(raw).values)


def finalize(raw: torch.Tensor, n: int, gen: torch.Generator
             ) -> torch.Tensor:
    """Exactly ``n`` sorted unique keys: a uniform choice of ``n``
    without replacement from the distinct values of ``raw`` (int64,
    >= 0).  Raises where ``raw`` holds fewer than ``n`` distinct values:
    the generator drew too few."""
    keys = sorted_unique(raw)
    del raw
    if keys.shape[0] < n:
        raise ValueError(f"{keys.shape[0]} distinct keys drawn, {n} "
                         "needed: the generator draws too few")
    if keys.shape[0] > n:
        keep = torch.randperm(keys.shape[0], generator=gen,
                              device=keys.device)[:n]
        keys = keys[torch.sort(keep).values]
    return keys
