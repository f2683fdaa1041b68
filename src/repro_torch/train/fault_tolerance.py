"""Fault tolerance & straggler mitigation for the multi-pod launcher.

This container has one host, so node failure and stragglers are driven
through a simulation hook (tests inject failures), but the POLICY code is
the real thing a 1000-node deployment runs:

  * heartbeat ledger: every host stamps each step; a host late by more than
    `straggler_factor` x median step time is a straggler, missing for
    `dead_after` consecutive steps is dead.
  * straggler response: log + (optionally) re-dispatch the step with the
    backup-worker policy (synchronous training tolerates K slow hosts by
    over-provisioning K spares; we model the bookkeeping).
  * death response: shrink the mesh to the largest (pods', data', model)
    grid that the remaining hosts cover, restore the latest checkpoint onto
    it (checkpoint.restore is mesh-elastic), continue.

A copy of the reference's `repro.train.fault_tolerance` (host-only
policy code, no JAX in it), so that the port imports nothing of the
reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class HostState:
    last_step: int = -1
    last_time: float = 0.0
    step_times: List[float] = dataclasses.field(default_factory=list)


class HeartbeatLedger:
    def __init__(self, n_hosts: int, straggler_factor: float = 2.0,
                 dead_after: int = 3):
        self.hosts: Dict[int, HostState] = {i: HostState() for i in range(n_hosts)}
        self.straggler_factor = straggler_factor
        self.dead_after = dead_after

    def beat(self, host: int, step: int, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        h = self.hosts[host]
        if h.last_step >= 0 and step > h.last_step:
            h.step_times.append((now - h.last_time) / (step - h.last_step))
            h.step_times = h.step_times[-32:]
        h.last_step, h.last_time = step, now

    def median_step_time(self) -> float:
        times = [t for h in self.hosts.values() for t in h.step_times]
        return float(np.median(times)) if times else 0.0

    def classify(self, step: int, now: Optional[float] = None
                 ) -> Tuple[List[int], List[int]]:
        """Returns (stragglers, dead) host ids at `step`."""
        now = time.monotonic() if now is None else now
        med = self.median_step_time()
        stragglers, dead = [], []
        for i, h in self.hosts.items():
            behind = step - h.last_step
            if behind >= self.dead_after:
                dead.append(i)
            elif med > 0 and (now - h.last_time) > self.straggler_factor * med:
                stragglers.append(i)
        return stragglers, dead


def shrink_mesh_shape(shape: Tuple[int, ...], axes: Tuple[str, ...],
                      lost_hosts: int, hosts_per_pod: int
                      ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Elastic policy: drop whole pods first (cheapest re-shard: the pod
    axis only carries DP), else halve the data axis."""
    shape = list(shape)
    lost_pods = -(-lost_hosts // hosts_per_pod)  # ceil
    if "pod" in axes:
        pi = axes.index("pod")
        if shape[pi] > lost_pods:
            shape[pi] -= lost_pods
            return tuple(shape), axes
        # all pods but one gone: collapse the pod axis entirely
        remaining = [s for i, s in enumerate(shape) if i != pi]
        return tuple(remaining), tuple(a for a in axes if a != "pod")
    di = axes.index("data")
    shape[di] = max(1, shape[di] // 2)
    return tuple(shape), axes


@dataclasses.dataclass
class RecoveryPlan:
    new_shape: Tuple[int, ...]
    new_axes: Tuple[str, ...]
    restore_step: Optional[int]
    global_batch_scale: float    # keep global batch via more grad accum


def plan_recovery(ledger: HeartbeatLedger, step: int, mesh_shape, mesh_axes,
                  hosts_per_pod: int, ckpt_latest: Optional[int]
                  ) -> Optional[RecoveryPlan]:
    _, dead = ledger.classify(step)
    if not dead:
        return None
    new_shape, new_axes = shrink_mesh_shape(
        tuple(mesh_shape), tuple(mesh_axes), len(dead), hosts_per_pod)
    old = int(np.prod(mesh_shape))
    new = int(np.prod(new_shape))
    return RecoveryPlan(new_shape, new_axes, ckpt_latest, old / new)
