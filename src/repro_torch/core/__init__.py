"""Learned index structures as torch modules (paper §2).

An index over a sorted array ``D`` maps a key to a bound ``(lo, hi)``
that always contains ``LB(x)``, followed by a last-mile search inside it.
Importing this package registers the builders (their schemas with them).
"""
from repro_torch.core.base import (IndexBuild, REGISTRY, SearchBound,
                                   get_index, lower_bound_oracle, register)
from repro_torch.core import spec  # schemas register below
# registration order is the reference's, so `spec.sweep_names()` (and a
# Tuner's tie-breaks) see the families in the same order
from repro_torch.core import (  # noqa: F401
    rmi, radix_spline, pgm, btree, rbs, hashmap)
from repro_torch.core import (  # noqa: F401
    analysis, plan, search, tuning, validate)
from repro_torch.core.plan import LookupPlan, lower
from repro_torch.core.spec import IndexSpec, Tuner

__all__ = [
    "IndexBuild",
    "IndexSpec",
    "LookupPlan",
    "SearchBound",
    "Tuner",
    "lower",
    "lower_bound_oracle",
    "REGISTRY",
    "register",
    "get_index",
    "spec",
]
