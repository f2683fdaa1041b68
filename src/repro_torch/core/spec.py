"""Declarative index construction: `IndexSpec` + typed schemas + the
budget tuner.

Every builder registers a typed hyperparameter schema (`register_schema`,
next to its `base.register`) carrying field types, bounds, defaults and
the CDFShop size ladder.  `IndexSpec` describes one build as a
JSON-serializable value, and `build(spec, keys)` validates it and then
calls the registered builder:

    IndexSpec(index, hyper, backend, last_mile)   # JSON-serializable
        --build(spec, keys, device)-->  IndexBuild

`Tuner` searches the spec space per dataset under an explicit budget:
``max_bytes`` is a HARD cap (a spec whose build exceeds it is never
returned; `BudgetError` if no rung fits), ``target_ns`` a soft goal on
the `analysis.cost_ns` latency proxy (smallest index meeting it wins,
else the fastest feasible).  With more than one candidate backend the
winner's lookup is *measured* per backend on the tuner's device and the
fastest is written into the returned spec.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import analysis, base, search
from repro_torch.kernels.common import encode_keys, resolve_device
from repro_torch.obs.trace import span

__all__ = [
    "BudgetError", "Candidate", "HyperField", "IndexSchema", "IndexSpec",
    "SpecError", "Tuner", "TuneResult", "SCHEMAS", "build", "coerce",
    "get_schema", "register_schema", "spec_ladder", "stride_sample",
    "sweep_names",
]

#: The plan-backend axis (mirrors `repro_torch.core.plan.BACKENDS`; a
#: literal so the spec layer stays importable below the plan).
BACKENDS = ("torch", "cuda")


class SpecError(ValueError):
    """An `IndexSpec` that does not satisfy its index's schema."""


class BudgetError(ValueError):
    """No candidate spec fits the tuner's hard byte budget."""


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HyperField:
    """One typed hyperparameter: type, default, and admissible values."""

    name: str
    type: type                          # int | float | str
    default: Any
    choices: Optional[Tuple] = None     # enum constraint (str fields)
    lo: Optional[float] = None          # inclusive numeric bounds
    hi: Optional[float] = None

    def coerce(self, index: str, value: Any) -> Any:
        """Validate + canonicalize one value (bool is NOT an int here)."""
        if self.type is int:
            if isinstance(value, bool) or not isinstance(
                    value, (int, np.integer)):
                raise SpecError(
                    f"{index}.{self.name}: expected int, got {value!r}")
            value = int(value)
        elif self.type is float:
            if isinstance(value, bool) or not isinstance(
                    value, (int, float, np.integer, np.floating)):
                raise SpecError(
                    f"{index}.{self.name}: expected float, got {value!r}")
            value = float(value)
        elif self.type is str:
            if not isinstance(value, str):
                raise SpecError(
                    f"{index}.{self.name}: expected str, got {value!r}")
        if self.choices is not None and value not in self.choices:
            raise SpecError(
                f"{index}.{self.name}: {value!r} not in {self.choices}")
        if self.lo is not None and value < self.lo:
            raise SpecError(f"{index}.{self.name}: {value!r} < min {self.lo}")
        if self.hi is not None and value > self.hi:
            raise SpecError(f"{index}.{self.name}: {value!r} > max {self.hi}")
        return value


@dataclasses.dataclass(frozen=True)
class IndexSchema:
    """Typed hyperparameter schema + CDFShop ladder for one index
    (rungs ordered SMALLEST to LARGEST expected size)."""

    index: str
    fields: Tuple[HyperField, ...]
    ladder: Tuple[Mapping[str, Any], ...]
    sweep: bool = True
    sweep_exclude_reason: str = ""

    def field_map(self) -> Dict[str, HyperField]:
        return {f.name: f for f in self.fields}

    def defaults(self) -> Dict[str, Any]:
        return {f.name: f.default for f in self.fields}


SCHEMAS: Dict[str, IndexSchema] = {}


def register_schema(index: str, fields: Sequence[HyperField],
                    ladder: Sequence[Mapping[str, Any]],
                    sweep: bool = True,
                    sweep_exclude_reason: str = "") -> IndexSchema:
    """Register the typed schema + size ladder for one index name."""
    if sweep == bool(sweep_exclude_reason):
        raise ValueError(f"{index}: sweep-excluded schemas (and only "
                         "those) must state a reason")
    schema = IndexSchema(index=index, fields=tuple(fields),
                         ladder=tuple(dict(r) for r in ladder),
                         sweep=sweep,
                         sweep_exclude_reason=sweep_exclude_reason)
    SCHEMAS[index] = schema
    return schema


def get_schema(index: str) -> IndexSchema:
    try:
        return SCHEMAS[index]
    except KeyError:
        raise SpecError(f"no schema registered for index {index!r}; "
                        f"known: {sorted(SCHEMAS)}") from None


def sweep_names() -> Tuple[str, ...]:
    """Index names in the default sweep (schema-declared, in
    registration order)."""
    return tuple(n for n, s in SCHEMAS.items() if s.sweep)


# ---------------------------------------------------------------------------
# IndexSpec
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=True)
class IndexSpec:
    """A declarative, serializable description of one index build.

    ``hyper`` may be partial: `validated()` fills schema defaults and
    type/range-checks every field.  ``backend`` is the `LookupPlan`
    backend the index is meant to serve with; ``last_mile`` None defers
    to the builder's own default (binary).
    """

    index: str
    hyper: Dict[str, Any] = dataclasses.field(default_factory=dict)
    backend: str = "torch"
    last_mile: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "hyper", dict(self.hyper))

    def validated(self) -> "IndexSpec":
        """Schema-checked copy with defaults filled; raises `SpecError`."""
        if self.index not in base.REGISTRY:
            raise SpecError(f"unknown index {self.index!r}; "
                            f"known: {sorted(base.REGISTRY)}")
        fields = get_schema(self.index).field_map()
        unknown = set(self.hyper) - set(fields)
        if unknown:
            raise SpecError(f"{self.index}: unknown hyperparameters "
                            f"{sorted(unknown)}; schema has {sorted(fields)}")
        hyper = {name: f.coerce(self.index, self.hyper.get(name, f.default))
                 for name, f in fields.items()}
        if self.backend not in BACKENDS:
            raise SpecError(f"unknown backend {self.backend!r}; "
                            f"one of {BACKENDS}")
        if self.last_mile is not None and \
                self.last_mile not in search.SEARCH_FNS:
            raise SpecError(f"unknown last_mile {self.last_mile!r}; "
                            f"one of {tuple(search.SEARCH_FNS)}")
        return IndexSpec(self.index, hyper, self.backend, self.last_mile)

    def replace(self, **kw) -> "IndexSpec":
        return dataclasses.replace(self, **kw)

    def canonical(self) -> Tuple:
        """Hashable identity (frozen dataclasses with dict fields are
        equality-comparable but not hashable)."""
        return (self.index, tuple(sorted(self.hyper.items())),
                self.backend, self.last_mile)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"index": self.index, "hyper": dict(self.hyper),
                             "backend": self.backend}
        if self.last_mile is not None:
            d["last_mile"] = self.last_mile
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "IndexSpec":
        unknown = set(d) - {"index", "hyper", "backend", "last_mile"}
        if unknown:
            raise SpecError(f"unknown IndexSpec keys {sorted(unknown)}")
        if "index" not in d:
            raise SpecError("IndexSpec dict needs an 'index' key")
        return cls(index=d["index"], hyper=dict(d.get("hyper", {})),
                   backend=d.get("backend", "torch"),
                   last_mile=d.get("last_mile"))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "IndexSpec":
        return cls.from_dict(json.loads(s))


def coerce(spec_or_name, hyper: Optional[Mapping[str, Any]] = None,
           backend: Optional[str] = None,
           last_mile: Optional[str] = None) -> IndexSpec:
    """Fold an `IndexSpec` OR a (name, hyper) pair, plus optional
    backend/last-mile overrides, into ONE validated spec.  Passing
    ``hyper`` alongside an `IndexSpec` is a `TypeError`."""
    if isinstance(spec_or_name, IndexSpec):
        if hyper is not None:
            raise TypeError(
                "pass hyperparameters inside the IndexSpec, not via hyper=")
        sp = spec_or_name
    else:
        sp = IndexSpec(spec_or_name, dict(hyper or {}))
    if backend is not None:
        sp = sp.replace(backend=backend)
    if last_mile is not None:
        sp = sp.replace(last_mile=last_mile)
    return sp.validated()


def build(spec: IndexSpec, keys: np.ndarray, device=None) -> base.IndexBuild:
    """THE index construction entry point: validate, then build on
    ``device`` (None: the CUDA card).  The validated spec rides in
    ``meta["spec"]``.  Traced as ``index.fit``."""
    spec = spec.validated()
    kwargs = dict(spec.hyper)
    if spec.last_mile is not None:
        kwargs["last_mile"] = spec.last_mile
    with span("index.fit", index=spec.index):
        b = base.REGISTRY[spec.index](np.asarray(keys), device=device,
                                      **kwargs)
    b.meta["spec"] = spec
    return b


# ---------------------------------------------------------------------------
# Generated ladders
# ---------------------------------------------------------------------------
def stride_sample(seq: Sequence, k: Optional[int]) -> List:
    """At most ``k`` elements spread evenly across ``seq``, ALWAYS
    including both ends when ``k >= 2``."""
    if k is None or k <= 0 or k >= len(seq):
        return list(seq)
    idx = np.unique(np.round(np.linspace(0, len(seq) - 1, k)).astype(int))
    return [seq[i] for i in idx]


def spec_ladder(index: str, max_configs: Optional[int] = None,
                backend: str = "torch",
                last_mile: Optional[str] = None) -> List[IndexSpec]:
    """The index's CDFShop ladder as validated `IndexSpec`s, smallest to
    largest size, stride-sampled to ``max_configs`` rungs (both size
    extremes kept)."""
    schema = get_schema(index)
    return [IndexSpec(index, dict(r), backend=backend,
                      last_mile=last_mile).validated()
            for r in stride_sample(schema.ladder, max_configs)]


# ---------------------------------------------------------------------------
# The budget tuner
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Candidate:
    """One evaluated rung: the spec, its build cost metrics, the
    `analysis.cost_ns` latency proxy, and the objective ``score`` the
    search ranks on (== ``cost_ns`` unless a Tuner ``objective``
    rescored it)."""

    spec: IndexSpec
    size_bytes: int
    cost_ns: float
    metrics: Dict[str, Any]
    score: Optional[float] = None

    def __post_init__(self):
        if self.score is None:
            object.__setattr__(self, "score", float(self.cost_ns))


@dataclasses.dataclass
class TuneResult:
    spec: IndexSpec                   # chosen spec, backend resolved
    build: base.IndexBuild            # the chosen build (reusable as-is)
    frontier: List[Candidate]         # Pareto front over (size, score)
    evaluated: List[Candidate]        # every rung the search touched
    backend_ns: Dict[str, float]      # measured ns/lookup per backend
    max_bytes: Optional[int]
    target_ns: Optional[float]
    chosen: Optional[Candidate] = None   # the winning Candidate record


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (the CPU's ops are synchronous)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass(frozen=True)
class Tuner:
    """Budget-driven spec search over the schema-generated ladders.

    - ``max_bytes``: HARD cap on `IndexBuild.size_bytes`.  Candidates
      over it are discarded; if nothing fits, `BudgetError`.
    - ``target_ns``: soft per-lookup goal on the `analysis.cost_ns`
      proxy: among candidates meeting it the SMALLEST wins (the paper's
      "smallest index that is fast enough"); if none meet it, the
      fastest feasible candidate wins.
    - neither: pure proxy-latency minimization under no size cap.

    Backend selection: with one entry in ``backends`` it is simply
    written into the chosen spec; with several, the winner's compiled
    lookup is *measured* per backend on the probe queries, on the device
    the tune runs on, and the fastest backend wins.
    """

    names: Optional[Sequence[str]] = None     # default: sweep_names()
    max_bytes: Optional[int] = None
    target_ns: Optional[float] = None
    backends: Sequence[str] = ("torch",)
    max_configs: Optional[int] = None         # stride-cap rungs per index
    n_queries: int = 2048                     # probe queries when not given
    seed: int = 0
    repeats: int = 2                          # timing repeats per backend
    #: measured/proxy cost rescale before ranking: None (trust proxy),
    #: a scalar applied to every family, or {index_name: ratio}
    calibration: Any = None
    #: optional workload-aware objective (duck-typed): ``queries(keys)``
    #: may supply the probe stream, ``score(spec, metrics, widths)``
    #: replaces the ranking scalar.  None = classic mean-cost proxy.
    objective: Any = None

    def tune(self, keys: np.ndarray, queries: Optional[np.ndarray] = None,
             device=None) -> TuneResult:
        """Search the ladders over ``keys``, building on ``device`` (None:
        the CUDA card)."""
        dev = resolve_device(device)
        keys = np.asarray(keys, dtype=np.uint64)
        names = tuple(self.names) if self.names is not None else sweep_names()
        for be in self.backends:
            if be not in BACKENDS:
                raise SpecError(f"unknown backend {be!r}; one of {BACKENDS}")
        if queries is not None:
            q = np.asarray(queries, dtype=np.uint64)
        else:
            q = None
            if self.objective is not None and \
                    hasattr(self.objective, "queries"):
                got = self.objective.queries(keys)
                if got is not None:
                    q = np.asarray(got, dtype=np.uint64)
            if q is None:
                q = self._probe_queries(keys)
        qt = encode_keys(q, dev)

        evaluated: List[Candidate] = []
        for name in names:
            for sp in spec_ladder(name, max_configs=self.max_configs,
                                  backend=self.backends[0]):
                b = build(sp, keys, device=dev)
                if b.meta.get("point_only"):
                    raise SpecError(
                        f"{name!r} is point-only: no lower-bound cost "
                        "model; exclude it from Tuner.names")
                lo, hi = b.lookup(b.state, qt)
                widths = np.maximum(
                    hi.cpu().numpy() - lo.cpu().numpy() + 1, 1)
                metrics = analysis.describe(b, widths)
                cost = analysis.cost_ns(
                    metrics, calibration=self._calibration_for(name))
                score = cost if self.objective is None else float(
                    self.objective.score(sp, metrics, widths))
                evaluated.append(
                    Candidate(spec=sp, size_bytes=b.size_bytes,
                              cost_ns=cost, metrics=metrics, score=score))
                del b   # keep ONE build alive at a time, not every ladder

        chosen = self._select(evaluated)
        front = set(base.pareto_front(
            [(c.size_bytes, c.score, c.spec.canonical())
             for c in evaluated]))
        frontier = [c for c in evaluated
                    if (c.size_bytes, c.score, c.spec.canonical()) in front]

        # one extra (deterministic, bit-identical) rebuild of the winner
        # is far cheaper than holding the whole search space's state
        chosen_build = build(chosen.spec, keys, device=dev)
        backend_ns: Dict[str, float] = {}
        best_backend = self.backends[0]
        if len(self.backends) > 1:
            from repro_torch.core import plan as plan_mod

            p = plan_mod.lower(chosen_build, encode_keys(keys, dev))
            for be in self.backends:
                fn = p.compile(backend=be)
                fn(qt)                                   # prepare + warm
                _sync(dev)
                best = float("inf")
                for _ in range(max(1, self.repeats)):
                    t0 = time.perf_counter()
                    fn(qt)
                    _sync(dev)
                    best = min(best, time.perf_counter() - t0)
                backend_ns[be] = best / len(q) * 1e9
            best_backend = min(backend_ns, key=backend_ns.get)

        spec = chosen.spec.replace(backend=best_backend)
        chosen_build.meta["spec"] = spec
        return TuneResult(spec=spec, build=chosen_build, frontier=frontier,
                          evaluated=evaluated, backend_ns=backend_ns,
                          max_bytes=self.max_bytes, target_ns=self.target_ns,
                          chosen=chosen)

    def tune_shards(self, keys: np.ndarray, offsets: Sequence[int],
                    queries: Optional[np.ndarray] = None,
                    device=None) -> List[TuneResult]:
        """Tune each contiguous key-range slice independently.

        ``offsets`` is a shard offset vector (len S+1).  Each shard's
        ladder search sees only its slice; a per-shard ``max_bytes`` of
        ``self.max_bytes / S`` keeps the summed footprint inside the
        original budget.
        """
        keys = np.asarray(keys, dtype=np.uint64)
        offs = [int(o) for o in offsets]
        s_eff = len(offs) - 1
        per = None if self.max_bytes is None else max(
            1, self.max_bytes // s_eff)
        sub = dataclasses.replace(self, max_bytes=per)
        q = None if queries is None else np.asarray(queries, dtype=np.uint64)
        results: List[TuneResult] = []
        for s in range(s_eff):
            sl = keys[offs[s]:offs[s + 1]]
            qs = None
            if q is not None:
                in_range = q[(q >= sl[0]) & (q <= sl[-1])]
                qs = in_range if in_range.size >= 64 else None
            results.append(sub.tune(sl, queries=qs, device=device))
        return results

    # -- internals -------------------------------------------------------
    def _calibration_for(self, index: str) -> float:
        """Resolve the measured/proxy rescale for one index family."""
        if self.calibration is None:
            return 1.0
        if isinstance(self.calibration, (int, float)):
            return float(self.calibration)
        return float(self.calibration.get(index, 1.0))

    def _probe_queries(self, keys: np.ndarray) -> np.ndarray:
        """Mixed present/absent probe stream (seeded; the reference's
        stream draw for draw)."""
        rng = np.random.default_rng(self.seed)
        m = min(self.n_queries, max(64, len(keys)))
        present = keys[rng.integers(0, len(keys), m // 2)]
        absent = rng.integers(int(keys[0]), max(int(keys[-1]),
                                                int(keys[0]) + 1),
                              m - m // 2, dtype=np.uint64)
        return np.concatenate([present, absent])

    def _select(self, cands: List[Candidate]) -> Candidate:
        feasible = [c for c in cands
                    if self.max_bytes is None
                    or c.size_bytes <= self.max_bytes]
        if not feasible:
            raise BudgetError(
                f"no spec fits max_bytes={self.max_bytes} "
                f"(smallest candidate: "
                f"{min(c.size_bytes for c in cands)} bytes)")
        if self.target_ns is not None:
            fast = [c for c in feasible if c.score <= self.target_ns]
            if fast:
                return min(fast, key=lambda c: (c.size_bytes, c.score))
        return min(feasible, key=lambda c: (c.score, c.size_bytes))
