"""Self-driving tuning subsystem.

Closes the loop the serve stack left open: the service *measures*
workload drift, dispersion inflation, and SLO burn
(`repro_torch.obs`), and this package *acts* on them — a `ShadowRetuner` daemon re-runs the
budget `Tuner` off the hot path under a workload-aware objective,
verifies the candidate bit-exactly against the sorted-array oracle, and
hot-swaps it through the existing `IndexRegistry` publish path only on
a modeled-cost win.  Tuned specs persist in a versioned JSON artifact
store keyed by (dataset fingerprint, byte budget, workload signature)
so warm starts skip the ladder sweep entirely.

Layering: this package sits between core and serve: it imports
`repro_torch.core` and `repro_torch.obs` only; the serve layer hands it
a service object duck-typed at runtime (no serve import, no cycle).

The port of the reference's `repro.autotune`.
"""
from repro_torch.autotune.objective import (WorkloadObjective,
                                            tail_weight_from_burn,
                                            workload_queries)
from repro_torch.autotune.retuner import AutotuneConfig, ShadowRetuner
from repro_torch.autotune.store import (SpecArtifact, SpecArtifactStore,
                                        dataset_fingerprint,
                                        workload_signature)

__all__ = [
    "AutotuneConfig",
    "ShadowRetuner",
    "SpecArtifact",
    "SpecArtifactStore",
    "WorkloadObjective",
    "dataset_fingerprint",
    "tail_weight_from_burn",
    "workload_queries",
    "workload_signature",
]
