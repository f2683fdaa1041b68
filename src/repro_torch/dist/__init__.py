"""Distributed execution layer over `torch.distributed`, as the
reference's `repro.dist`: sharding rules, pipeline schedule, comms.

  sharding           logical-axis-name -> spec resolution over a
                     `launch/mesh.py` DeviceMesh, and its DTensor
                     placements (the model code only names axes, never
                     touches device topology)
  pipeline_parallel  microbatched GPipe schedule over the `model` mesh dim
                     with exact parity against the sequential stack
  compression        int8 gradient all-reduce with error feedback

The collectives are `torch.distributed`'s: NCCL for CUDA tensors, gloo
for CPU tensors, on a process group that the caller has set up with an
explicit address.  Importing this package touches no device and no
process group.
"""
from __future__ import annotations

from repro_torch.dist import compression, pipeline_parallel, sharding  # noqa: F401

__all__ = ["compression", "pipeline_parallel", "sharding"]
