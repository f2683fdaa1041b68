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
                                |.searched_windows(q)      -> (lo, hi) the cuda lookup searches

A plan is a `bounds` stage (the index's state dict, a predict function
``(state, q) -> (lo, hi)`` with ``hi`` inclusive, and the window bound
``max_err``) composed with a last-mile stage run by a backend:

  ``"torch"``  the `repro_torch.core.search.SEARCH_FNS` searches as plain
               torch ops, on whatever device the plan's data lies;
  ``"cuda"``   the hand-written kernels: the bounded-search kernel
               consuming the plan's bounds (any index), or, where an index
               registers one, a fused whole-plan executor (RMI: the
               ``rmi_lookup`` kernel, bounds and search in one launch; PGM:
               the ``pgm_lookup`` kernel, the descent and search in one
               launch).  For a plan whose data lies on the CPU each kernel
               wrapper takes its plain version, so this backend runs
               everywhere too.

Both backends return the exact lower-bound rank, so they agree bit for
bit on every plan.  A point-only index (robin_hash) predicts ``(found,
pos)`` instead and runs no last mile on either backend.  ``data``, the
queries and a merged lookup's delta are encoded keys
(`repro_torch.kernels.common.encode_keys`); the delta is sorted and
padded with ``INT64_MAX``, the code of ``UINT64_MAX``.  Nothing is
compiled: the ``compile*`` entry points cache the callables per plan.

Traced (`repro_torch.obs.trace.span`): ``index.lower``, ``index.compile``
(a callable made on a cache miss), ``lookup`` (each call of a `compile`
callable) and, on the unfused cuda path, ``lookup.predict`` (for PGM
with its ``pgm.*`` spans, which the fused kernel does not show; for
RadixSpline its ``rs.*``).  The window counter (`searched_windows`,
reduced by `window_counts`) reads what the cuda lookup's searching
kernel is handed; RadixSpline's `knot_windows`, what its knot search
is.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import base, search
from repro_torch.kernels.bounded_search.ops import clip_windows
# the health monitor's histogram geometry: `obs.health` owns it
from repro_torch.obs.health import (HEALTH_DISP_BUCKETS,  # noqa: F401
                                    HEALTH_STATS_SIZE,
                                    HEALTH_TRAFFIC_BUCKETS)
from repro_torch.obs.trace import span

__all__ = ["BACKENDS", "BoundsStage", "LookupPlan", "health_edges",
           "health_stats_expr",
           "lower", "pack_health_stats", "register_fused",
           "search_steps", "window_counts",
           "FUSED_KERNELS", "FUSED_LOWERERS", "FUSED_WINDOWS"]

#: The backend axis every lookup consumer can select on.
BACKENDS = ("torch", "cuda")

#: Pad of a scan window past the end and of a padded delta: the code of
#: UINT64_MAX.
SENTINEL = torch.iinfo(torch.int64).max

#: index name -> plan -> fn(q) -> int64 positions.  A fused executor
#: replaces the whole predict+search pipeline with one kernel path;
#: registered per index family, used by backend="cuda".
FUSED_LOWERERS: Dict[str, Callable] = {}

#: index name -> the one kernel its fused executor launches a call (a
#: family without one launches ``bounded_search``)
FUSED_KERNELS: Dict[str, str] = {}


#: index name -> ``(plan, q) -> (lo, hi, max_width)``: the windows its
#: fused executor searches, before the kernel's clip
FUSED_WINDOWS: Dict[str, Callable] = {}


def register_fused(name: str, kernel: str):
    def deco(fn):
        FUSED_LOWERERS[name] = fn
        FUSED_KERNELS[name] = kernel
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


def health_edges(n: int, max_err: int, device) -> Dict[str, torch.Tensor]:
    """The constant bucket edges of `health_stats_expr` for a plan of
    ``n`` keys and bound ``max_err``, as tensors on ``device``.  Made once
    an expression, outside any CUDA-graph capture: a host-to-device copy
    of a host list cannot be captured."""
    K = HEALTH_TRAFFIC_BUCKETS
    dt = torch.int32 if int(n) < 2 ** 31 else torch.int64
    return {
        "steps": torch.tensor(
            [1 << j for j in range(max(1, int(max_err).bit_length()))],
            dtype=dt, device=device),
        "disp": torch.tensor([1 << j for j in range(HEALTH_DISP_BUCKETS - 1)],
                             dtype=dt, device=device),
        # rank r is in traffic bucket r*K//n  <=>  r >= ceil(j*n/K) for
        # exactly (bucket index + 1) edges j
        "traffic": torch.tensor(
            [(j * int(n) + K - 1) // K for j in range(1, K)], dtype=dt,
            device=device),
    }


def health_stats_expr(pos, lo, hi, n: int, max_err: int, n_valid,
                      point_only: bool = False, edges=None):
    """Fixed-size reductions for the health monitor.

    ``pos`` is the [B] int64 result lanes, ``(lo, hi)`` the bounds-stage
    window (ignored when ``point_only``), ``n_valid`` (an int or a 0-d
    device tensor) masks out pad lanes.  Returned: a log2
    prediction-displacement histogram (bucket 0 = exact hit, bucket j =
    ``[2^(j-1), 2^j)``, the last bucket overflows), a rank-quantized
    traffic histogram (bucket ``r*K//n``, counted against the ceil rank
    edges), and sums of displacement, bound width and last-mile steps.
    Displacement, width and rank are int32 when ``n`` permits, as in the
    reference.  ``edges`` are `health_edges` for the same ``n`` and
    ``max_err`` on ``pos``'s device (made here when None).
    """
    B = pos.shape[0]
    dev = pos.device
    if edges is None:
        edges = health_edges(n, max_err, dev)
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
        steps = torch.where(valid, search_steps(width, edges["steps"]),
                            0).to(dt)
    disp_hist = _cum_bucket_hist(disp, edges["disp"], valid)
    rank = torch.clamp(pos, 0, n - 1).to(dt)
    traffic_hist = _cum_bucket_hist(rank, edges["traffic"], valid)
    return {
        "n": valid.sum(dtype=torch.int32),
        "disp_hist": disp_hist,
        "traffic_hist": traffic_hist,
        "disp_sum": disp.sum(dtype=torch.int64),
        "disp_max": disp.max().to(torch.int64),
        "width_sum": width.sum(dtype=torch.int64),
        "steps_sum": steps.sum(dtype=torch.int64),
    }


def search_steps(width, edges) -> torch.Tensor:
    """``ceil(log2(width))`` of each window width as int32 (0 for a width
    of 0 or 1): a binary search's trip count over the window, counted as
    the powers of two ``edges`` (``1, 2, 4, ...``, as far as the widest
    window needs) that lie below the width."""
    return (width[:, None] > edges[None, :]).sum(dim=1, dtype=torch.int32)


#: queries a `window_counts` pass reduces at once (bounds its temporaries)
WINDOW_CHUNK = 1 << 20


def window_counts(lo, hi) -> Dict[str, int]:
    """``queries``, ``width_sum`` and ``steps_sum`` (`search_steps`) of
    windows ``[lo, hi]`` (``hi`` inclusive; an empty window has width 0),
    as Python ints: one host read at the end."""
    width = torch.clamp(hi.to(torch.int64) - lo.to(torch.int64) + 1, min=0)
    widest = int(width.max()) if width.numel() else 0
    edges = torch.tensor([1 << j for j in range(max(1, widest.bit_length()))],
                         dtype=torch.int64, device=width.device)
    steps = torch.zeros((), dtype=torch.int64, device=width.device)
    for i in range(0, width.shape[0], WINDOW_CHUNK):
        steps += search_steps(width[i:i + WINDOW_CHUNK], edges).sum(
            dtype=torch.int64)
    return {"queries": int(width.shape[0]),
            "width_sum": int(width.sum(dtype=torch.int64)),
            "steps_sum": int(steps)}


def pack_health_stats(stats) -> torch.Tensor:
    """One stats dict as a single int64 ``[HEALTH_STATS_SIZE]`` vector: 5
    scalars, then the two histograms (the reference's layout, which
    `repro_torch.obs.health.unpack_stats` reads)."""
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
                with span("lookup.predict"):
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
        edges = health_edges(n, max_err, self.data.device)
        if self.point_only:
            run = self.lb_expr(backend)

            def run_point_instr(q, n_valid):
                pos = run(q)
                stats = health_stats_expr(pos, None, None, n, max_err,
                                          n_valid, point_only=True,
                                          edges=edges)
                return pos, pack_health_stats(stats)

            return run_point_instr

        base_fn = self._instr_base_expr(backend)

        def run_instr(q, n_valid):
            pos, lo, hi = base_fn(q)
            stats = health_stats_expr(pos, lo, hi, n, max_err, n_valid,
                                      edges=edges)
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
        edges = health_edges(n, max_err, self.data.device)

        def merged_instr(q, n_valid, delta_padded):
            lb_base, lo, hi = base_fn(q)
            lb_delta = torch.searchsorted(delta_padded, q, side="left")
            stats = health_stats_expr(lb_base, lo, hi, n, max_err, n_valid,
                                      edges=edges)
            return lb_base + lb_delta, pack_health_stats(stats)

        return merged_instr

    # -- cached entry points ------------------------------------------------
    def _compiled(self, key, make_expr) -> Callable:
        """The cached callable of ``key``, tagged with ``lookup_plan`` (this
        plan): the serving executor captures a tagged callable as a CUDA
        graph on the card and runs any other callable as it is.  Making
        it is traced as ``index.compile``."""
        fn = self._cache.get(key)
        if fn is None:
            with span("index.compile", kind=key[0], backend=key[1]):
                fn = self._cache[key] = make_expr()
            fn.lookup_plan = self
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
                              lambda: _spanned(self.lb_expr(backend, fused)))

    def searched_windows(self, q):
        """The windows the cuda lookup (`compile` ``("cuda")``) searches
        for encoded queries ``q``, as int64 ``(lo, hi)``, ``hi``
        inclusive: a registered fused executor's own (RMI: the f32
        state's bounds through the kernel's arithmetic, clipped with the
        state's ``max_err``), else the plan's predict clipped as the
        bounded-search kernel clips it with ``max_err``; both clips are
        ``lookup.cuh``'s ``clip_window``."""
        if self.point_only:
            raise ValueError(f"{self.name!r} is point-only: no windows")
        windows = FUSED_WINDOWS.get(self.name) if self.fused else None
        if windows is not None:
            lo, hi, max_width = windows(self, q)
        else:
            lo, hi = self.bounds.predict(self.bounds.state, q)
            max_width = self.bounds.max_err
        start, count = clip_windows(self.n, lo, max_width, hi)
        return start, start + count - 1

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

    def to(self, device) -> "LookupPlan":
        """This plan placed on ``device``: its verified bounds state and
        keys copied there, with the state a fused executor derived from
        them (RMI's f32 tables, verified once, through the kernel's own
        arithmetic, where the plan was lowered; PGM's kernel view of its
        levels).  The copy makes its own callables; nothing it runs reads
        another device.  Itself when it already lies there."""
        if self.data.device == torch.device(device):
            return self
        derived = {k: base.to_device(v, device)
                   for k, v in self._cache.items() if isinstance(k, str)}
        return dataclasses.replace(
            self,
            bounds=dataclasses.replace(
                self.bounds,
                state=base.to_device(self.bounds.state, device)),
            data=self.data.to(device), meta=dict(self.meta),
            _cache=derived)

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
    with span("index.lower", index=build.name):
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


def _spanned(fn: Callable) -> Callable:
    """``fn`` with each call traced as ``lookup`` (``queries``: the
    batch's length)."""

    def lookup(q):
        with span("lookup", queries=q.shape[0]):
            return fn(q)

    return lookup


def _rmi_f32_state(plan: LookupPlan):
    """The plan's f32 RMI state (made once a plan): refit from the plan's
    keys with its error table verified through the kernel's own
    arithmetic."""
    from repro_torch.kernels.common import decode_keys
    from repro_torch.kernels.rmi_lookup import ops as rops

    st = plan._cache.get("_rmi_f32_state")
    if st is None:
        st = rops.prepare_f32_state(
            decode_keys(plan.data),
            branching=int(plan.meta.get("branching", 1024)),
            device=plan.data.device)
        plan._cache["_rmi_f32_state"] = st
    return st


@register_fused("rmi", "rmi_lookup")
def _rmi_fused(plan: LookupPlan) -> Callable:
    """Whole-plan executor for RMI: the fused f32 lookup kernel (bounds
    and last mile in one launch), returning int64 ranks.  The f32 state's
    error table holds under the kernel's own arithmetic, so the result is
    still the exact LB rank."""
    from repro_torch.kernels.rmi_lookup import ops as rops

    st = _rmi_f32_state(plan)
    data = plan.data

    return lambda q: rops.rmi_lookup(st, data, q)


def _rmi_windows(plan: LookupPlan, q):
    """The fused kernel's windows before its clip: the f32 bounds
    (`rmi_bounds`, the kernel's arithmetic) and the state's ``max_err``."""
    from repro_torch.kernels.rmi_lookup import ops as rops

    st = _rmi_f32_state(plan)
    lo, hi = rops.rmi_bounds(st, q)
    return lo, hi, st.max_err


FUSED_WINDOWS["rmi"] = _rmi_windows


def _pgm_state(plan: LookupPlan):
    """The plan's PGM state as the fused kernel reads it (made once a
    plan): the build's verified levels, errors and ``max_err``, with each
    level's search trip count."""
    from repro_torch.kernels.pgm_lookup import ops as pops

    st = plan._cache.get("_pgm_state")
    if st is None:
        st = plan._cache["_pgm_state"] = pops.prepare_state(
            plan.bounds.state, plan.bounds.max_err)
    return st


@register_fused("pgm", "pgm_lookup")
def _pgm_fused(plan: LookupPlan) -> Callable:
    """Whole-plan executor for PGM: the ``pgm_lookup`` kernel (the descent
    and the last mile in one launch), returning int64 ranks.  It searches
    the windows of the plan's own predict with its ``max_err``, so
    `LookupPlan.searched_windows` needs no entry in `FUSED_WINDOWS`."""
    from repro_torch.kernels.pgm_lookup import ops as pops

    st = _pgm_state(plan)
    data = plan.data

    return lambda q: pops.pgm_lookup(st, data, q)
