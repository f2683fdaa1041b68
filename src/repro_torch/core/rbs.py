"""Radix binary search (paper §4.1.1 baseline, from SOSD [17]), and the
binary-search baseline.

RBS stores only the radix table of the RadixSpline approach: ``table[p]``
is the LB of the first key with prefix p.  Lookup = one uint64 shift
(`kernels.common.radix_prefix`) + two table gathers.  It shows the paper's
face-dataset failure mode: top-end outliers inflate the key range, making
the fixed prefix bits nearly useless.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import base, spec
from repro_torch.core.radix_spline import radix_shape
from repro_torch.kernels.common import (encode_keys, radix_prefix,
                                        resolve_device)

spec.register_schema(
    "rbs",
    fields=[spec.HyperField("radix_bits", int, 16, lo=1, hi=28)],
    # smallest -> largest size: the table is 2^radix_bits entries
    ladder=[dict(radix_bits=r) for r in (6, 8, 10, 12, 14, 16, 18, 20, 22)],
)

spec.register_schema(
    "binary_search",
    fields=[],
    ladder=[dict()],
)


def _assemble(keys: np.ndarray, table: np.ndarray, radix_bits: int,
              last_mile: str, dev) -> base.IndexBuild:
    n = len(keys)
    r, shift = radix_shape(keys, radix_bits)
    table = np.asarray(table).astype(np.int64)
    max_gap = int(np.max(table[1:] - table[:-1]))
    state = {"table": torch.from_numpy(table).to(dev),
             "kmin": encode_keys(keys[:1], dev)[0]}

    def lookup(state, q) -> base.SearchBound:
        p = radix_prefix(q, state["kmin"], shift, r)
        return base.clip_bound(state["table"][p], state["table"][p + 1], n)

    return base.IndexBuild(
        name="rbs",
        state=state,
        lookup=lookup,
        size_bytes=base.nbytes(table),
        hyper=dict(radix_bits=r, last_mile=last_mile),
        meta={"max_err": max_gap + 1, "levels": 1, "n": n},
    )


@base.register("rbs")
def build(
    keys: np.ndarray,
    radix_bits: int = 16,
    last_mile: str = "binary",
    device=None,
) -> base.IndexBuild:
    """The radix table over sorted uint64 ``keys``, on ``device`` (None:
    the CUDA card)."""
    dev = resolve_device(device)
    keys = np.asarray(keys)
    r, shift = radix_shape(keys, radix_bits)
    prefixes = ((keys - np.uint64(keys[0])) >> np.uint64(shift)).astype(
        np.int64)
    table = np.searchsorted(prefixes, np.arange((1 << r) + 1), side="left")
    return _assemble(keys, table, r, last_mile, dev)


@base.register("binary_search")
def build_bs(keys: np.ndarray, last_mile: str = "binary",
             device=None) -> base.IndexBuild:
    """The paper's BS baseline: size zero, bound = the whole array."""
    dev = resolve_device(device)
    n = len(keys)

    def lookup(state, q) -> base.SearchBound:
        z = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
        return z, torch.full(q.shape, n, dtype=torch.int64, device=q.device)

    return base.IndexBuild(
        name="binary_search",
        state={},
        lookup=lookup,
        size_bytes=0,
        hyper=dict(last_mile=last_mile),
        meta={"max_err": n + 1, "levels": 0, "n": n, "device": str(dev)},
    )
