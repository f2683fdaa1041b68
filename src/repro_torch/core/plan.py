"""`LookupPlan` IR: one lowering target for every index.

Every index reduces to the same two-phase shape (paper §5): *predict a
position, then bounded last-mile search*.

    IndexBuild --lower()--> LookupPlan(bounds, data, last_mile)
                                |.compile(backend)         -> q -> LB ranks
                                |.compile_scan(m)          -> q -> (LB, window)
                                |.compile_merged()         -> (q, delta) -> merged LB
                                |.compile_merged_scan(m)   -> (q, delta) -> merged (LB, window)
                                |.compile_instrumented()   -> (q, n_valid) -> (LB, health stats)
                                |.compile_instrumented_merged()
                                                           -> (q, n_valid, delta) -> (LB, stats)

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
bit on every plan.  A point-only index (robin_hash) predicts ``(found,
pos)`` instead and runs no last mile on either backend.  ``data``, the
queries and a merged lookup's delta are encoded keys
(`repro_torch.kernels.common.encode_keys`); the delta is sorted and
padded with ``INT64_MAX``, the code of ``UINT64_MAX``.  Nothing is
compiled: the ``compile*`` entry points cache the callables per plan.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import base, search

__all__ = ["BACKENDS", "BoundsStage", "LookupPlan", "health_stats_expr",
           "lower", "pack_health_stats", "register_fused",
           "FUSED_LOWERERS"]

#: The backend axis every lookup consumer can select on.
BACKENDS = ("torch", "cuda")

#: The health monitor's histogram geometry, copied from the reference's
#: host half (`repro.obs.health`): log2 displacement buckets and
#: rank-quantized traffic buckets.  The packed stats vector is 5 int64
#: scalars, then the two histograms.
HEALTH_DISP_BUCKETS = 24
HEALTH_TRAFFIC_BUCKETS = 64
HEALTH_STATS_SIZE = 5 + HEALTH_DISP_BUCKETS + HEALTH_TRAFFIC_BUCKETS

#: Pad of a scan window past the end and of a padded delta: the code of
#: UINT64_MAX.
SENTINEL = torch.iinfo(torch.int64).max

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
    ``hi - lo + 1 <= max_err``.  Point-only indexes (robin_hash) instead
    return ``(found, pos)`` and set ``max_err = 0``."""

    state: Any
    predict: Callable[[Any, base.Array], base.SearchBound]
    max_err: int


def _window_gather(data, pos, m: int):
    """[B] start positions -> [B, m] record window, one gather.

    Past-the-end lanes hold `SENTINEL` (the delta buffer's pad), so
    windows of different plans merge by plain sort."""
    n = data.shape[0]
    idx = pos[:, None] + torch.arange(m, dtype=pos.dtype,
                                      device=pos.device)[None, :]
    if n == 0:
        return torch.full(idx.shape, SENTINEL, dtype=data.dtype,
                          device=data.device)
    window = data[torch.clamp(idx, 0, n - 1)]
    return window.masked_fill(idx >= n, SENTINEL)


def _cum_bucket_hist(vals, edges, valid):
    """Bucket counts without a scatter: count ``vals >= edge`` per edge
    over the valid lanes, then difference the cumulative counts."""
    c = ((vals[:, None] >= edges[None, :]) & valid[:, None]).sum(
        dim=0, dtype=torch.int32)
    total = valid.sum(dtype=torch.int32)
    cext = torch.cat([total[None], c, c.new_zeros(1)])
    return cext[:-1] - cext[1:]


def health_stats_expr(pos, lo, hi, n: int, max_err: int, n_valid,
                      point_only: bool = False):
    """Fixed-size reductions for the health monitor.

    ``pos`` is the [B] int64 result lanes, ``(lo, hi)`` the bounds-stage
    window (ignored when ``point_only``), ``n_valid`` masks out pad lanes.
    Returned: a log2 prediction-displacement histogram (bucket 0 = exact
    hit, bucket j = ``[2^(j-1), 2^j)``, the last bucket overflows), a
    rank-quantized traffic histogram (bucket ``r*K//n``, counted against
    the ceil rank edges), and sums of displacement, bound width and
    last-mile steps.  Displacement, width and rank are int32 when ``n``
    permits, as in the reference.
    """
    B = pos.shape[0]
    K = HEALTH_TRAFFIC_BUCKETS
    dev = pos.device
    lane = torch.arange(B, dtype=torch.int32, device=dev) < n_valid
    dt = torch.int32 if int(n) < 2 ** 31 else torch.int64
    if point_only:
        valid = lane & (pos >= 0)
        disp = torch.zeros(B, dtype=dt, device=dev)
        width = valid.to(dt)
        steps = torch.zeros(B, dtype=dt, device=dev)
    else:
        valid = lane
        lo_n, hi_n = lo.to(dt), hi.to(dt)
        mid = lo_n + (hi_n - lo_n) // 2
        disp = torch.where(valid, (pos.to(dt) - mid).abs(), 0)
        width = torch.where(valid, hi_n - lo_n + 1, 0)
        # binary-search trip count over the bound: ceil(log2(width))
        s_edges = torch.tensor(
            [1 << j for j in range(max(1, int(max_err).bit_length()))],
            dtype=dt, device=dev)
        steps = torch.where(
            valid, (width[:, None] > s_edges[None, :]).sum(
                dim=1, dtype=torch.int32), 0).to(dt)
    d_edges = torch.tensor([1 << j for j in range(HEALTH_DISP_BUCKETS - 1)],
                           dtype=dt, device=dev)
    disp_hist = _cum_bucket_hist(disp, d_edges, valid)
    rank = torch.clamp(pos, 0, n - 1).to(dt)
    # rank r is in traffic bucket r*K//n  <=>  r >= ceil(j*n/K) for
    # exactly (bucket index + 1) edges j
    t_edges = torch.tensor([(j * int(n) + K - 1) // K for j in range(1, K)],
                           dtype=dt, device=dev)
    traffic_hist = _cum_bucket_hist(rank, t_edges, valid)
    return {
        "n": valid.sum(dtype=torch.int32),
        "disp_hist": disp_hist,
        "traffic_hist": traffic_hist,
        "disp_sum": disp.sum(dtype=torch.int64),
        "disp_max": disp.max().to(torch.int64),
        "width_sum": width.sum(dtype=torch.int64),
        "steps_sum": steps.sum(dtype=torch.int64),
    }


def pack_health_stats(stats) -> torch.Tensor:
    """One stats dict as a single int64 ``[HEALTH_STATS_SIZE]`` vector: 5
    scalars, then the two histograms (the reference's layout, which
    `repro.obs.health.unpack_stats` reads)."""
    scalars = torch.stack([
        stats["n"].to(torch.int64), stats["disp_sum"], stats["disp_max"],
        stats["width_sum"], stats["steps_sum"]])
    return torch.cat([scalars, stats["disp_hist"].to(torch.int64),
                      stats["traffic_hist"].to(torch.int64)])


@dataclasses.dataclass(frozen=True, eq=False)
class LookupPlan:
    """One index lowered to predict -> bounded-search, backend-agnostic."""

    name: str
    bounds: BoundsStage
    data: Any                  # encoded sorted keys on the plan's device
    n: int
    last_mile: str = "binary"
    point_only: bool = False
    fused: Optional[Callable] = None   # whole-plan kernel executor factory
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # per-plan cache: (kind, backend, ...) -> callable, plus the state a
    # fused executor derives from the plan (built once per plan)
    _cache: Dict[Any, Any] = dataclasses.field(
        default_factory=dict, repr=False)

    # -- expression builders ----------------------------------------------
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
        if self.point_only:

            def run_point(q):
                found, pos = predict(state, q)
                return torch.where(found, pos, -1).to(torch.int64)

            return run_point

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

    def merged_expr(self, backend: str = "torch") -> Callable:
        """Delta rank correction: ``(q, delta_padded) -> LB_base(q) +
        LB_delta(q)``.  Exact because base and delta are disjoint sorted
        sets; the delta's `SENTINEL` pads are never below a query."""
        run = self.lb_expr(backend)

        def merged(q, delta_padded):
            lb_delta = torch.searchsorted(delta_padded, q, side="left")
            return run(q) + lb_delta

        return merged

    def scan_expr(self, m: int, backend: str = "torch") -> Callable:
        """Range-scan materialization: ``q -> (LB, window[B, m])``, the
        ``m`` records from ``LB(q)`` as one windowed gather."""
        if self.point_only:
            raise ValueError(f"{self.name!r} is point-only: no scans")
        run = self.lb_expr(backend)
        data = self.data

        def scan(q):
            pos = run(q)
            return pos, _window_gather(data, pos, m)

        return scan

    def merged_scan_expr(self, m: int, backend: str = "torch") -> Callable:
        """Scan over the merged (base + delta) view: gather ``m`` from each
        side and keep the first ``m`` of their sorted union, which holds
        the merged array's next ``m`` records; both pad with
        `SENTINEL`."""
        if self.point_only:
            raise ValueError(f"{self.name!r} is point-only: no scans")
        run = self.lb_expr(backend)
        data = self.data

        def scan(q, delta_padded):
            pos_b = run(q)
            pos_d = torch.searchsorted(delta_padded, q, side="left")
            window = torch.sort(torch.cat(
                [_window_gather(data, pos_b, m),
                 _window_gather(delta_padded, pos_d, m)], dim=-1),
                dim=-1).values[:, :m]
            return pos_b + pos_d, window

        return scan

    def _instr_base_expr(self, backend: str) -> Callable:
        """``q -> (LB, lo, hi)``: one predict shared by the search and the
        stats on the torch backend; the cuda paths keep their own lookup
        and run the plan's predict again for the stats."""
        predict, state = self.bounds.predict, self.bounds.state
        if backend == "torch":
            fn = search.SEARCH_FNS[self.last_mile]
            data, max_err = self.data, self.bounds.max_err

            def base_torch(q):
                lo, hi = predict(state, q)
                return fn(data, q, lo, hi, max_err).to(torch.int64), lo, hi

            return base_torch

        run = self.lb_expr(backend)

        def base_other(q):
            pos = run(q)
            lo, hi = predict(state, q)
            return pos, lo, hi

        return base_other

    def instrumented_expr(self, backend: str = "torch") -> Callable:
        """``(q, n_valid) -> (LB, packed stats)``: the lookup plus the
        `health_stats_expr` reduction flattened by `pack_health_stats`.
        The positions come from the same ops as the plain lookup; the
        stats from the plan's own bounds (never a fused kernel's f32
        state), so they do not depend on the backend."""
        n, max_err = self.n, self.bounds.max_err
        if self.point_only:
            run = self.lb_expr(backend)

            def run_point_instr(q, n_valid):
                pos = run(q)
                stats = health_stats_expr(pos, None, None, n, max_err,
                                          n_valid, point_only=True)
                return pos, pack_health_stats(stats)

            return run_point_instr

        base_fn = self._instr_base_expr(backend)

        def run_instr(q, n_valid):
            pos, lo, hi = base_fn(q)
            stats = health_stats_expr(pos, lo, hi, n, max_err, n_valid)
            return pos, pack_health_stats(stats)

        return run_instr

    def instrumented_merged_expr(self, backend: str = "torch") -> Callable:
        """``(q, n_valid, delta_padded) -> (merged LB, packed stats)``.
        The stats describe the base plan; the ranks are `merged_expr`'s."""
        if self.point_only:
            raise ValueError(
                f"{self.name!r} is point-only: no merged lookups")
        base_fn = self._instr_base_expr(backend)
        n, max_err = self.n, self.bounds.max_err

        def merged_instr(q, n_valid, delta_padded):
            lb_base, lo, hi = base_fn(q)
            lb_delta = torch.searchsorted(delta_padded, q, side="left")
            stats = health_stats_expr(lb_base, lo, hi, n, max_err, n_valid)
            return lb_base + lb_delta, pack_health_stats(stats)

        return merged_instr

    # -- cached entry points ------------------------------------------------
    def _compiled(self, key, make_expr) -> Callable:
        fn = self._cache.get(key)
        if fn is None:
            fn = self._cache[key] = make_expr()
        return fn

    def compile(self, backend: str = "torch",
                fused: Optional[bool] = None) -> Callable:
        """Cached ``q -> int64 LB ranks`` (the canonical fused lookup)."""
        # normalize fused before keying the cache: the default (None) and
        # its resolved value must alias to ONE callable
        if backend != "cuda" or self.point_only:
            fused = None
        elif fused is None:
            fused = self.fused is not None
        return self._compiled(("lb", backend, fused),
                              lambda: self.lb_expr(backend, fused))

    def compile_merged(self, backend: str = "torch") -> Callable:
        return self._compiled(("merged", backend),
                              lambda: self.merged_expr(backend))

    def compile_scan(self, m: int, backend: str = "torch") -> Callable:
        return self._compiled(("scan", int(m), backend),
                              lambda: self.scan_expr(int(m), backend))

    def compile_merged_scan(self, m: int, backend: str = "torch") -> Callable:
        return self._compiled(("merged_scan", int(m), backend),
                              lambda: self.merged_scan_expr(int(m), backend))

    def compile_instrumented(self, backend: str = "torch") -> Callable:
        return self._compiled(("instr", backend),
                              lambda: self.instrumented_expr(backend))

    def compile_instrumented_merged(self, backend: str = "torch") -> Callable:
        return self._compiled(("instr_merged", backend),
                              lambda: self.instrumented_merged_expr(backend))

    def build_displacement_quantile(self, q: float = 0.99,
                                    sample: int = 65536) -> float:
        """Displacement quantile of the plan's own keys: for key
        ``keys[i]`` the true rank is ``i``, so displacement is ``|i -
        mid(predict(keys[i]))|``, over an evenly strided sample of up to
        ``sample`` keys, cached per plan.  Point-only plans: 0."""
        key = ("build_disp", float(q), int(sample))
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        if self.point_only or self.n == 0:
            self._cache[key] = 0.0
            return 0.0
        idx = np.linspace(0, self.n - 1,
                          min(self.n, int(sample))).astype(np.int64)
        lo, hi = self.bounds.predict(
            self.bounds.state,
            self.data[torch.from_numpy(idx).to(self.data.device)])
        lo = lo.cpu().numpy().astype(np.int64)
        hi = hi.cpu().numpy().astype(np.int64)
        mid = lo + (hi - lo) // 2
        val = float(np.quantile(np.abs(idx - mid), q))
        self._cache[key] = val
        return val

    def scan(self, q, m: int, backend: str = "torch"):
        """Materialize ``m`` records from ``LB(q)``."""
        return self.compile_scan(m, backend)(q)


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
        point_only=bool(build.meta.get("point_only", False)),
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
