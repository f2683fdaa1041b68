"""Declarative index construction: `IndexSpec` + typed schemas.

Every builder registers a typed hyperparameter schema (`register_schema`,
next to its `base.register`) carrying field types, bounds, defaults and
the CDFShop size ladder.  `IndexSpec` describes one build as a
JSON-serializable value, and `build(spec, keys)` validates it and then
calls the registered builder:

    IndexSpec(index, hyper, backend, last_mile)   # JSON-serializable
        --build(spec, keys, device)-->  IndexBuild
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import base, search

__all__ = [
    "HyperField", "IndexSchema", "IndexSpec", "SpecError", "SCHEMAS",
    "build", "coerce", "get_schema", "register_schema",
]

#: The plan-backend axis (mirrors `repro_torch.core.plan.BACKENDS`; a
#: literal so the spec layer stays importable below the plan).
BACKENDS = ("torch", "cuda")


class SpecError(ValueError):
    """An `IndexSpec` that does not satisfy its index's schema."""


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
    ``meta["spec"]``."""
    spec = spec.validated()
    kwargs = dict(spec.hyper)
    if spec.last_mile is not None:
        kwargs["last_mile"] = spec.last_mile
    b = base.REGISTRY[spec.index](np.asarray(keys), device=device, **kwargs)
    b.meta["spec"] = spec
    return b
