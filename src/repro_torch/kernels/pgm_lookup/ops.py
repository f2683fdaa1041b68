"""A PGM's state as the fused kernel reads it, and the whole lookup.

`prepare_state` takes a PGM build's state (its levels, bottom first, each
level's verified error, the leaf's half-width ``e0`` and ``n``) as it
lies on the plan's device, and adds each level's search trip count.  The
kernel (``csrc/pgm_lookup.cu``) repeats `repro_torch.core.pgm.descend`'s
arithmetic step for step, so the errors the build verified through those
torch ops hold for it.

`pgm_lookup` sends a CUDA tensor to the kernel, one launch a call, the
windows feeding the bounded search in registers; a CPU tensor goes to
`pgm_lookup_plain`: the build's own descent (with its ``pgm.*``
spans), then
`lower_bound_windows_plain` over each query's ``(lo, hi)`` with the
plan's ``max_err``, which is B1's search at B1's depth (the kernel's
``kNearBlocks``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.core import pgm
from repro_torch.kernels.bounded_search.ops import lower_bound_windows_plain
from repro_torch.kernels.common import lb_steps
from repro_torch.kernels.pgm_lookup import kernel


@dataclasses.dataclass
class PGMState:
    """A PGM build's state on one device (``state``, what `pgm.descend`
    reads: ``levels``, ``errs``, ``e0``, ``n``), the plan's window bound
    and each level's trip count."""

    state: dict
    max_err: int
    steps: Tuple[int, ...]      # bounded_binary's trip count, by level
    #: the kernel's argument, made at the first launch
    model: Any = dataclasses.field(default=None, init=False, repr=False,
                                   compare=False)


def prepare_state(state: dict, max_err: int) -> PGMState:
    """The kernel's view of a PGM build's ``state`` with window bound
    ``max_err``, on the state's device, its f64 levels as they are.
    Raises for what the kernel cannot descend: more than
    `kernel.MAX_DEPTH` levels, ``n`` outside ``[1, 2^31)``, or a top level
    whose anchors descend (its count is an upper bound)."""
    levels, n = state["levels"], int(state["n"])
    if len(levels) > kernel.MAX_DEPTH:
        raise ValueError(
            f"a PGM of {len(levels)} levels: pgm_lookup descends at most "
            f"{kernel.MAX_DEPTH}; compile it with fused=False")
    if not 0 < n < 2 ** 31:
        raise ValueError(f"n={n} keys: pgm_lookup needs 0 < n < 2^31")
    top = levels[-1][0]
    if not bool((top[1:] >= top[:-1]).all()):
        raise ValueError("the top level's anchors are not ascending")
    return PGMState(
        state=state, max_err=int(max_err),
        steps=tuple(lb_steps(2 * int(e) + 3) for e in state["errs"]))


def pgm_lookup_plain(state: PGMState, data, queries):
    """The kernel's function as plain torch ops: the build's descent, then
    the search over each query's own window, as int64 ranks."""
    lo, hi = pgm.descend(state.state, queries)
    return lower_bound_windows_plain(data, queries, lo, state.max_err,
                                     hi).to(torch.int64)


def pgm_lookup(state: PGMState, data, queries):
    """End-to-end: the PGM's descent -> bounded last-mile search -> exact
    LB, as int64 ranks; one kernel launch on the card."""
    if queries.device.type == "cpu":
        return pgm_lookup_plain(state, data, queries)
    return kernel.launch_lookup(state, data, queries)
