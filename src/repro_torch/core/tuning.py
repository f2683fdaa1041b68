"""CDFShop-style configuration sweeps (paper §3.1 / §4.2).

The paper tunes every structure across ~10 configurations from minimum
to maximum size and reports the Pareto frontier.  The size ladders are
generated from the per-index hyperparameter schemas (`core.spec`):
`LADDERS` is a derived view for callers that think in hyper dicts, and
`sweep` builds every rung through the one validated `spec.build` entry
point.  ``max_configs`` caps a sweep by stride-sampling ACROSS each
ladder, both size extremes always included.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.core import base
from repro_torch.core import spec as spec_mod

#: Index names in the default sweep, generated from the schemas.
#: `robin_hash` is schema-excluded with a reason (point-only, no LB).
DEFAULT_SWEEP = spec_mod.sweep_names()

#: Derived hyper-dict view of the schema ladders (the source of truth is
#: `spec.SCHEMAS[name].ladder`).
LADDERS: Dict[str, List[dict]] = {
    name: [dict(rung) for rung in schema.ladder]
    for name, schema in spec_mod.SCHEMAS.items()
}


def spec_sweep(names: Optional[Iterable[str]] = None,
               max_configs: Optional[int] = None,
               backend: str = "torch") -> List[spec_mod.IndexSpec]:
    """The sweep as validated `IndexSpec`s (no builds), smallest to
    largest per index, stride-sampled to ``max_configs`` rungs."""
    out: List[spec_mod.IndexSpec] = []
    for name in (DEFAULT_SWEEP if names is None else names):
        out.extend(spec_mod.spec_ladder(name, max_configs=max_configs,
                                        backend=backend))
    return out


def sweep(keys: np.ndarray, names: Optional[Iterable[str]] = None,
          max_configs: Optional[int] = None,
          device=None) -> List[base.IndexBuild]:
    """Build every (stride-sampled) rung of every ladder via specs, on
    ``device`` (None: the CUDA card)."""
    return [spec_mod.build(s, keys, device=device)
            for s in spec_sweep(names, max_configs=max_configs)]
