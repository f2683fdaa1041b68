"""`repro_torch.mutable`: a write path for the learned indexes.

The port of the reference's `repro.mutable`.  Inserts land in a small
sorted `DeltaBuffer`; lookups merge the base index's result with a
search over the delta by *rank correction* (``LB_merged = LB_base +
LB_delta``: lower bounds over disjoint sorted sets add); a
threshold-triggered compaction rebuilds base + delta into a fresh
generation published through the serving registry's atomic hot swap.
"""
from repro_torch.mutable.delta import UINT64_MAX, DeltaBuffer
from repro_torch.mutable.index import LB_INDEXES, MutableIndex, MutableView

__all__ = ["UINT64_MAX", "DeltaBuffer", "LB_INDEXES", "MutableIndex",
           "MutableView"]
