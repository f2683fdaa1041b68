"""Common abstractions for index structures (paper §2).

An index structure maps a lookup key to a search bound ``(lo, hi)`` that
must contain ``LB(x)``, the smallest index i with ``D[i] >= x`` (C++
``lower_bound``).  ``hi`` is inclusive: valid means ``lo <= LB(x) <= hi``.

Every concrete index provides:

  build(keys, **hyper, device) -> state   (numpy fits, device verification)
  lookup(state, queries) -> (lo, hi)      (torch ops, vectorized)
  size_bytes                              (the paper's "size" axis)

``state`` is a plain dict of tensors on one device; queries are keys in
the codec of `repro_torch.kernels.common` (int64, sign bit flipped).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core import _pla
from repro_torch.kernels.common import keys_to_f64  # noqa: F401  (re-export)

Array = Any
SearchBound = Tuple[Array, Array]  # (lo, hi) int64 tensors, hi inclusive


@dataclasses.dataclass(frozen=True)
class IndexBuild:
    """A built index: state dict + the functions that interpret it."""

    name: str
    state: Any
    lookup: Callable[[Any, Array], SearchBound]
    size_bytes: int
    hyper: Dict[str, Any]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        """The device the state lives on (an index with no state tensor,
        the binary-search baseline, names it in ``meta``)."""
        for t in _tensors(self.state):
            return t.device
        return torch.device(self.meta["device"])


def _tensors(x):
    """The tensors of a state: a tensor, or dicts, lists and tuples of
    them."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def to_device(x, device):
    """A copy of a state on ``device``: every tensor of ``x`` (a tensor,
    or dicts, lists, tuples and dataclasses of them) copied there, and
    anything else kept as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, device) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: to_device(getattr(x, f.name), device)
            for f in dataclasses.fields(x) if f.init})
    return x


# ---------------------------------------------------------------------------
# Registry: name -> build function
# ---------------------------------------------------------------------------
REGISTRY: Dict[str, Callable[..., IndexBuild]] = {}


def register(name: str):
    def deco(fn):
        REGISTRY[name] = fn
        return fn

    return deco


def get_index(name: str) -> Callable[..., IndexBuild]:
    return REGISTRY[name]


# ---------------------------------------------------------------------------
# Oracle + shared helpers
# ---------------------------------------------------------------------------
def lower_bound_oracle(keys: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Ground-truth LB(x) (numpy, host side)."""
    return np.searchsorted(keys, queries, side="left")


def np_keys_to_f64(keys: np.ndarray) -> np.ndarray:
    return keys.astype(np.float64)


def grouped_keys(keys: np.ndarray):
    """The fit points of the PLA builders: f64-rounded unique keys, the
    first position of each, and the widest group of keys that round
    alike (`core._pla.group_rounded`)."""
    return _pla.group_rounded(np_keys_to_f64(keys),
                              np.arange(len(keys), dtype=np.float64))


def clip_bound(lo, hi, n: int) -> SearchBound:
    lo = torch.clamp(lo, 0, n).to(torch.int64)
    hi = torch.clamp(hi, 0, n).to(torch.int64)
    return lo, hi


def nbytes(*arrays) -> int:
    total = 0
    for a in arrays:
        if isinstance(a, torch.Tensor):
            total += a.numel() * a.element_size()
        else:
            total += np.asarray(a).nbytes
    return total


def pareto_front(points):
    """points: list of (size_bytes, latency_ns, tag). Returns the subset not
    dominated by any other point (smaller size AND lower latency)."""
    out = []
    for p in points:
        dominated = any(
            (q[0] <= p[0] and q[1] < p[1]) or (q[0] < p[0] and q[1] <= p[1])
            for q in points
        )
        if not dominated:
            out.append(p)
    return sorted(out)
