"""`LookupPlan` IR, the lookup half: one lowering target for every index.

Every index reduces to the same two-phase shape (paper §5): *predict a
position, then bounded last-mile search*.

    IndexBuild --lower()--> LookupPlan(bounds, data, last_mile)
                                |.compile(backend) -> q -> int64 LB ranks

A plan is a `bounds` stage (the index's state dict, a predict function
``(state, q) -> (lo, hi)`` with ``hi`` inclusive, and the window bound
``max_err``) composed with a last-mile stage run by a backend:

  ``"torch"``  the `repro_torch.core.search.SEARCH_FNS` searches as plain
               torch ops, on whatever device the plan's data lies;
  ``"cuda"``   the hand-written kernels: the bounded-search kernel
               consuming the plan's bounds (any index), or, where an index
               registers one, a fused whole-plan executor (RMI: the
               ``rmi_lookup`` kernel, bounds and search in one launch).  For
               a plan whose data lies on the CPU each kernel wrapper takes
               its plain version, so this backend runs everywhere too.

Both backends return the exact lower-bound rank, so they agree bit for
bit on every plan.  ``data`` and the queries are encoded keys
(`repro_torch.kernels.common.encode_keys`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core import base, search

__all__ = ["BACKENDS", "BoundsStage", "LookupPlan", "lower",
           "register_fused", "FUSED_LOWERERS"]

#: The backend axis every lookup consumer can select on.
BACKENDS = ("torch", "cuda")

#: index name -> plan -> fn(q) -> int64 positions.  A fused executor
#: replaces the whole predict+search pipeline with one kernel path;
#: registered per index family, used by backend="cuda".
FUSED_LOWERERS: Dict[str, Callable] = {}


def register_fused(name: str):
    def deco(fn):
        FUSED_LOWERERS[name] = fn
        return fn

    return deco


@dataclasses.dataclass(frozen=True)
class BoundsStage:
    """The predict half of a plan: ``predict(state, q) -> (lo, hi)`` with
    ``hi`` inclusive, ``lo <= LB(q) <= hi`` for every uint64 query, and
    ``hi - lo + 1 <= max_err``."""

    state: Any
    predict: Callable[[Any, base.Array], base.SearchBound]
    max_err: int


@dataclasses.dataclass(frozen=True, eq=False)
class LookupPlan:
    """One index lowered to predict -> bounded-search, backend-agnostic."""

    name: str
    bounds: BoundsStage
    data: Any                  # encoded sorted keys on the plan's device
    n: int
    last_mile: str = "binary"
    fused: Optional[Callable] = None   # whole-plan kernel executor factory
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # per-plan cache: (kind, backend, fused) -> callable, plus the state a
    # fused executor derives from the plan (built once per plan)
    _cache: Dict[Any, Any] = dataclasses.field(
        default_factory=dict, repr=False)

    def lb_expr(self, backend: str = "torch",
                fused: Optional[bool] = None) -> Callable:
        """``q -> int64 LB ranks``.

        ``fused=None`` uses the registered whole-plan executor when the
        backend is cuda and the index has one; ``fused=False`` forces the
        generic bounds -> `lower_bound_windows` path.
        """
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        predict, state = self.bounds.predict, self.bounds.state
        max_err, data = self.bounds.max_err, self.data

        if backend == "cuda":
            if fused is None:
                fused = self.fused is not None
            if fused:
                if self.fused is None:
                    raise ValueError(
                        f"plan {self.name!r} has no fused kernel executor")
                return self.fused(self)

            from repro_torch.kernels.bounded_search.ops import \
                lower_bound_windows

            def run_cuda(q):
                lo, hi = predict(state, q)
                # each query searches its own [lo, hi], which holds LB by
                # the bounds contract
                return lower_bound_windows(
                    data, q, lo, max_width=max_err, hi=hi).to(torch.int64)

            return run_cuda

        fn = search.SEARCH_FNS[self.last_mile]

        def run_torch(q):
            lo, hi = predict(state, q)
            return fn(data, q, lo, hi, max_err).to(torch.int64)

        return run_torch

    def compile(self, backend: str = "torch",
                fused: Optional[bool] = None) -> Callable:
        """Cached ``q -> int64 LB ranks`` (the canonical fused lookup)."""
        # normalize fused before keying the cache: the default (None) and
        # its resolved value must alias to ONE callable
        if backend != "cuda":
            fused = None
        elif fused is None:
            fused = self.fused is not None
        key = ("lb", backend, fused)
        fn = self._cache.get(key)
        if fn is None:
            fn = self._cache[key] = self.lb_expr(backend, fused)
        return fn


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------
def lower(build: base.IndexBuild, data,
          last_mile: Optional[str] = None) -> LookupPlan:
    """Lower a built index to its `LookupPlan` over encoded ``data``.

    ``last_mile`` defaults to the hyperparameter the index was built with
    (falling back to binary).
    """
    if last_mile is None:
        last_mile = build.hyper.get("last_mile", "binary")
    n = int(build.meta.get("n", data.shape[0]))
    bounds = BoundsStage(
        state=build.state,
        predict=build.lookup,
        max_err=int(build.meta.get("max_err", n + 1)),
    )
    return LookupPlan(
        name=build.name,
        bounds=bounds,
        data=data,
        n=n,
        last_mile=last_mile,
        fused=FUSED_LOWERERS.get(build.name),
        meta=dict(build.hyper),
    )


@register_fused("rmi")
def _rmi_fused(plan: LookupPlan) -> Callable:
    """Whole-plan executor for RMI: the fused f32 lookup kernel (bounds
    and last mile in one launch), returning int64 ranks.  The f32 state is
    refit from the plan's keys with its error table verified through the
    kernel's own arithmetic, so the result is still the exact LB rank."""
    from repro_torch.kernels.common import decode_keys
    from repro_torch.kernels.rmi_lookup import ops as rops

    st = plan._cache.get("_rmi_f32_state")
    if st is None:
        st = rops.prepare_f32_state(
            decode_keys(plan.data),
            branching=int(plan.meta.get("branching", 1024)),
            device=plan.data.device)
        plan._cache["_rmi_f32_state"] = st
    data = plan.data

    return lambda q: rops.rmi_lookup(st, data, q)
