"""Operation mixes, the `Workload` trace object, and its on-disk format.

A `Workload` is a flat, replayable trace: one op code + one uint64
operand per step (plus a scan length for range ops), with the metadata
that produced it: the unit every mixed-workload consumer shares, so
"same seed" means "bit-identical operation stream" across all of them
(and across the port and the reference).

Semantics:

  read    operand is a lookup key; result is ``LB(key)`` over the merged
          (base + delta) view — the paper's lower-bound contract.
  insert  operand is a new key; set semantics (inserting a present key is
          a no-op), result is the 0/1 admitted flag.
  range   operand is the scan start key, ``aux`` the scan length; the
          positioning result is ``LB(key)``, identical to a read — the
          scan itself is sequential post-positioning work.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.workloads.distributions import DISTRIBUTIONS

__all__ = ["OP_READ", "OP_INSERT", "OP_RANGE", "OP_NAMES", "MIXES",
           "Workload", "make_workload", "make_point_queries"]

OP_READ, OP_INSERT, OP_RANGE = 0, 1, 2
OP_NAMES = {OP_READ: "read", OP_INSERT: "insert", OP_RANGE: "range"}
_OP_CODES = {v: k for k, v in OP_NAMES.items()}

#: Named operation mixes in the YCSB mold (fractions over {read, insert,
#: range}).  ycsb_c == read_only is kept under both names so sweeps can
#: use the YCSB ladder uniformly.
MIXES: Dict[str, Dict[str, float]] = {
    "read_only": {"read": 1.0},
    "ycsb_a": {"read": 0.5, "insert": 0.5},
    "ycsb_b": {"read": 0.95, "insert": 0.05},
    "ycsb_c": {"read": 1.0},
    "ycsb_e": {"range": 0.95, "insert": 0.05},
}


@dataclasses.dataclass(frozen=True)
class Workload:
    """One replayable trace: parallel op/operand arrays + provenance."""

    ops: np.ndarray      # (m,) uint8 op codes
    keys: np.ndarray     # (m,) uint64 operands
    aux: np.ndarray      # (m,) int64: range length for OP_RANGE, else 0
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def n_ops(self) -> int:
        return int(self.ops.size)

    def counts(self) -> Dict[str, int]:
        return {name: int(np.sum(self.ops == code))
                for code, name in OP_NAMES.items()}

    # -- on-disk trace format (one .npz, meta as embedded JSON) ----------
    def save(self, path: str) -> None:
        np.savez(path, ops=self.ops, keys=self.keys, aux=self.aux,
                 meta=np.frombuffer(
                     json.dumps(self.meta).encode(), dtype=np.uint8))

    @staticmethod
    def load(path: str) -> "Workload":
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode()) if "meta" in z else {}
            return Workload(ops=z["ops"].astype(np.uint8),
                            keys=z["keys"].astype(np.uint64),
                            aux=z["aux"].astype(np.int64),
                            meta=meta)


def _resolve_mix(mix) -> Dict[str, float]:
    spec = MIXES[mix] if isinstance(mix, str) else dict(mix)
    probs = {op: float(spec.get(op, 0.0)) for op in ("read", "insert", "range")}
    total = sum(probs.values())
    if total <= 0:
        raise ValueError(f"mix {mix!r} has no positive op fraction")
    return {op: p / total for op, p in probs.items()}


def make_workload(keys: np.ndarray, n_ops: int, mix="ycsb_b",
                  dist: str = "zipfian", seed: int = 0,
                  present_frac: float = 0.9, range_len: int = 64,
                  **dist_kw) -> Workload:
    """Generate a seeded trace of ``n_ops`` operations over ``keys``.

    ``mix`` is a name from `MIXES` or a ``{op: fraction}`` dict; ``dist``
    names the rank sampler for read/range targets (`DISTRIBUTIONS`).
    Reads/ranges target a present key with probability ``present_frac``,
    else a uniform absent draw over the padded key range (the paper's §2
    validity definition covers every integer, so absent lookups are part
    of the contract, not an error path).  Insert operands are uniform
    interior draws; already-present ones dedup to no-ops at apply time.

    Determinism: one `np.random.Generator` seeded with ``seed`` drives
    every draw in a fixed order, so equal arguments give bit-identical
    traces on any host.
    """
    keys = np.asarray(keys, dtype=np.uint64)
    if keys.size == 0:
        raise ValueError("empty key set")
    probs = _resolve_mix(mix)
    sampler = DISTRIBUTIONS[dist]
    rng = np.random.default_rng(seed)

    codes = np.array([_OP_CODES[o] for o in ("read", "insert", "range")],
                     dtype=np.uint8)
    ops = rng.choice(codes, size=n_ops,
                     p=[probs["read"], probs["insert"], probs["range"]])

    lo, hi = int(keys[0]), int(keys[-1])
    operand = np.empty(n_ops, dtype=np.uint64)
    aux = np.zeros(n_ops, dtype=np.int64)

    is_point = ops != OP_INSERT          # read + range share the sampler
    n_point = int(is_point.sum())
    if n_point:
        ranks = sampler(rng, n_point, keys.size, **dist_kw)
        target = keys[ranks]
        absent = rng.random(n_point) >= present_frac
        if absent.any():
            target = target.copy()
            # upper bound clamped to 2^64 (exclusive): a key set may
            # legally contain UINT64_MAX (the mutable layer admits it)
            target[absent] = rng.integers(
                max(lo - 1000, 0), min(hi + 1000, 1 << 64),
                size=int(absent.sum()), dtype=np.uint64)
        operand[is_point] = target
    n_ins = n_ops - n_point
    if n_ins:
        operand[~is_point] = rng.integers(
            max(lo, 1), max(hi, 2), size=n_ins, dtype=np.uint64)
    aux[ops == OP_RANGE] = int(range_len)

    meta = dict(mix=(mix if isinstance(mix, str) else probs), dist=dist,
                seed=int(seed), n_keys=int(keys.size),
                present_frac=float(present_frac), range_len=int(range_len),
                **{k: (float(v) if isinstance(v, (int, float)) else v)
                   for k, v in dist_kw.items()})
    return Workload(ops=ops, keys=operand, aux=aux, meta=meta)


def make_point_queries(keys: np.ndarray, m: int, seed: int = 0,
                       present_frac: float = 0.8, dist: str = "uniform",
                       **dist_kw) -> np.ndarray:
    """Seeded point-query batch: ``present_frac`` sampled present keys
    (via the ``dist`` rank sampler) + uniform absent draws, shuffled.

    With ``dist="uniform"`` the draw sequence is exactly the one
    `data/sosd.make_queries` produces.
    """
    keys = np.asarray(keys, dtype=np.uint64)
    rng = np.random.default_rng(seed)
    n_present = int(m * present_frac)
    present = keys[DISTRIBUTIONS[dist](rng, n_present, keys.size, **dist_kw)]
    lo, hi = int(keys[0]), int(keys[-1])
    # the min() clamp only departs from the legacy draw where the legacy
    # expression overflowed uint64 (max key above 2^64-1001)
    absent = rng.integers(max(lo - 1000, 0), min(hi + 1000, 1 << 64),
                          size=m - n_present, dtype=np.uint64)
    q = np.concatenate([present, absent])
    rng.shuffle(q)
    return q.astype(np.uint64)
