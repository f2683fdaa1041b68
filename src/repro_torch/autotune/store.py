"""Versioned spec-artifact store: persist tuned `IndexSpec`s as JSON.

The paper's frontiers are *tuned* frontiers — a tuned spec is an
expensive artifact (a full ladder sweep builds every rung), and it is
a pure function of three things: the dataset, the byte budget, and the
workload shape.  This store keys on exactly that triple so a service
restarting on the same data under the same traffic skips the sweep:

- **dataset fingerprint** — sha256 over (n, endpoints, a strided
  subsample) of the sorted key array.  Strided, not full, so the hash
  of a 10^8-key array costs a bounded read; endpoints + n make
  truncation/extension collisions implausible.
- **byte budget** — the Tuner's hard ``max_bytes`` cap (0 = uncapped).
- **workload signature** — the 64-bucket key-space traffic histogram
  (the health layer's telemetry), normalized and quantized to a few
  levels.
  Quantization is the cache's tolerance knob: traffic that differs
  only in noise maps to the same signature; a hot spot that moved
  buckets does not.

Artifacts append as versions under their key (never overwritten), so
the store doubles as a tuning history.  Writes are atomic
(tmp + rename) and lock-guarded; the store is safe to share between a
daemon thread and the serving thread.

A copy of the reference's `repro.autotune.store`: the fingerprint, the
signature and the store key are bit-identical to the reference's, so a
store directory written by one package is read by the other.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import spec as spec_mod

#: quantization levels for the workload signature — coarse on purpose:
#: the signature should survive sampling noise but split real hot spots
SIGNATURE_LEVELS = 8
#: subsample cap for the dataset fingerprint
FINGERPRINT_SAMPLE = 4096


def dataset_fingerprint(keys: np.ndarray) -> str:
    """Stable content hash of a sorted key array (bounded read)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    h = hashlib.sha256()
    h.update(np.int64(keys.size).tobytes())
    if keys.size:
        h.update(keys[0].tobytes())
        h.update(keys[-1].tobytes())
        step = max(1, keys.size // FINGERPRINT_SAMPLE)
        h.update(keys[::step].tobytes())
    return h.hexdigest()[:16]


def workload_signature(traffic_hist: Optional[np.ndarray],
                       levels: int = SIGNATURE_LEVELS) -> str:
    """Quantized traffic histogram → short signature string.

    ``None`` or an empty/zero histogram signs as ``"uniform"`` — the
    cold-start signature, which also matches genuinely flat traffic
    (a uniform histogram quantizes to all-equal levels and is folded
    into the same token for readability).
    """
    if traffic_hist is None:
        return "uniform"
    hist = np.asarray(traffic_hist, dtype=np.float64)
    total = float(hist.sum())
    if hist.size == 0 or total <= 0:
        return "uniform"
    # scale so a perfectly uniform histogram sits at level 1 everywhere
    q = np.minimum(levels - 1,
                   np.floor(hist / total * hist.size).astype(np.int64))
    if np.all(q == q[0]):
        return "uniform"
    body = "".join(str(int(v)) for v in q)
    return f"h{hashlib.sha256(body.encode()).hexdigest()[:12]}"


@dataclasses.dataclass(frozen=True)
class SpecArtifact:
    """One persisted tuning outcome: the spec(s), their objective score,
    and enough provenance to audit where they came from."""

    specs: List[spec_mod.IndexSpec]   # 1 entry (broadcast) or S (routed)
    score: float                      # objective score at tune time
    version: int                      # per-key monotone version
    created_unix: float
    meta: Dict[str, Any]              # trigger, signature, budget, ...

    def to_dict(self) -> Dict[str, Any]:
        return {
            "specs": [json.loads(s.to_json()) for s in self.specs],
            "score": self.score,
            "version": self.version,
            "created_unix": self.created_unix,
            "meta": self.meta,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SpecArtifact":
        return SpecArtifact(
            specs=[spec_mod.IndexSpec.from_json(json.dumps(s))
                   for s in d["specs"]],
            score=float(d["score"]),
            version=int(d["version"]),
            created_unix=float(d["created_unix"]),
            meta=dict(d.get("meta", {})),
        )


class SpecArtifactStore:
    """One JSON file per (fingerprint, budget, signature) key, holding a
    version list of `SpecArtifact`s; ``get`` returns the newest."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    # -- keying ----------------------------------------------------------
    @staticmethod
    def key(fingerprint: str, max_bytes: Optional[int],
            signature: str) -> str:
        return f"{fingerprint}_b{int(max_bytes or 0)}_{signature}"

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.json")

    # -- IO --------------------------------------------------------------
    def _read(self, key: str) -> List[Dict[str, Any]]:
        try:
            with open(self._path(key)) as f:
                doc = json.load(f)
            return list(doc.get("versions", []))
        except (OSError, ValueError):
            return []

    def _write(self, key: str, versions: List[Dict[str, Any]]) -> None:
        doc = {"key": key, "versions": versions}
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, self._path(key))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- API -------------------------------------------------------------
    def get(self, fingerprint: str, max_bytes: Optional[int],
            signature: str) -> Optional[SpecArtifact]:
        """Newest artifact under the key, or None (counts hit/miss)."""
        key = self.key(fingerprint, max_bytes, signature)
        with self._lock:
            versions = self._read(key)
            if not versions:
                self.misses += 1
                return None
            self.hits += 1
            return SpecArtifact.from_dict(versions[-1])

    def put(self, fingerprint: str, max_bytes: Optional[int],
            signature: str, specs: Sequence[spec_mod.IndexSpec],
            score: float, meta: Optional[Dict[str, Any]] = None
            ) -> SpecArtifact:
        """Append a new version under the key and return it."""
        key = self.key(fingerprint, max_bytes, signature)
        with self._lock:
            versions = self._read(key)
            art = SpecArtifact(
                specs=list(specs), score=float(score),
                version=len(versions) + 1, created_unix=time.time(),
                meta=dict(meta or {}))
            versions.append(art.to_dict())
            self._write(key, versions)
            return art

    def lookup_or_tune(self, fingerprint: str, max_bytes: Optional[int],
                       signature: str,
                       tune_fn: Callable[[], "tuple[List[spec_mod.IndexSpec], float, Dict[str, Any]]"]
                       ) -> "tuple[SpecArtifact, bool]":
        """Cached specs if present, else run ``tune_fn`` and persist.

        Returns ``(artifact, cache_hit)``.  ``tune_fn`` runs OUTSIDE the
        store lock (a ladder sweep is seconds-to-minutes; readers must
        not block on it) — a concurrent tuner for the same key simply
        appends the next version.
        """
        art = self.get(fingerprint, max_bytes, signature)
        if art is not None:
            return art, True
        specs, score, meta = tune_fn()
        return self.put(fingerprint, max_bytes, signature,
                        specs, score, meta), False

    def entries(self) -> List[Dict[str, Any]]:
        """Newest version per key, for surfacing (small; re-reads disk)."""
        out = []
        with self._lock:
            try:
                names = sorted(os.listdir(self.root))
            except OSError:
                return out
            for fn in names:
                if not fn.endswith(".json"):
                    continue
                versions = self._read(fn[:-5])
                if versions:
                    latest = dict(versions[-1])
                    latest["key"] = fn[:-5]
                    latest["n_versions"] = len(versions)
                    out.append(latest)
        return out

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses}
