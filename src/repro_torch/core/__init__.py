"""Learned index structures as torch modules (paper §2).

An index over a sorted array ``D`` maps a key to a bound ``(lo, hi)``
that always contains ``LB(x)``, followed by a last-mile search inside it.
Importing this package registers the builders (their schemas with them).
"""
from repro_torch.core.base import (IndexBuild, REGISTRY, SearchBound,
                                   get_index, lower_bound_oracle, register)
from repro_torch.core import spec  # schemas register below
from repro_torch.core import rmi  # noqa: F401
from repro_torch.core import plan, search, validate  # noqa: F401
from repro_torch.core.plan import LookupPlan, lower
from repro_torch.core.spec import IndexSpec

__all__ = [
    "IndexBuild",
    "IndexSpec",
    "LookupPlan",
    "SearchBound",
    "lower",
    "lower_bound_oracle",
    "REGISTRY",
    "register",
    "get_index",
    "spec",
]
