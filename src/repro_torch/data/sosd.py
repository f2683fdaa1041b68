"""Surrogate generators for the paper's four real-world datasets (§4.1.2).

A numpy copy of the reference's generators: the same seed gives the same
keys bit for bit.  The surrogates reproduce the documented CDF *shape* of
each dataset (Figure 6 and the text):

  amzn  book popularity counts — smooth heavy-tailed CDF, locally near-linear
  face  user IDs ~ uniform over (0, 2^50) plus ~100 outliers in (2^59, 2^64)
  osm   Hilbert-curve cell ids of clustered 2-D locations — globally smooth,
        locally erratic
  wiki  edit timestamps — bursty arrival process with periodic rate

All generators return exactly ``n`` sorted unique uint64 keys, fully
determined by ``seed``.

Real datasets: when ``REPRO_SOSD_DIR`` points at a directory holding the
published SOSD uint64 binaries (books/fb/osm_cellids/wiki_ts), ``generate``
loads and deterministically subsamples the real keys instead (`load_real`).
This module never downloads them.
"""
from __future__ import annotations

import hashlib
import os
import warnings

import numpy as np

__all__ = ["DATASETS", "SOSD_SOURCES", "generate", "load_real",
           "make_queries"]


def _sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique`` by one sort: the same array.  numpy 2.3's
    ``np.unique`` goes through a hash table first, which is far slower
    than the sort at the surrogates' full 200M-key size."""
    a = np.sort(a)
    keep = np.empty(len(a), bool)
    keep[:1] = True
    np.not_equal(a[1:], a[:-1], out=keep[1:])
    return a[keep]


def _finalize(raw: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    keys = _sorted_unique(raw.astype(np.uint64))
    while len(keys) < n:  # top up collisions
        extra = rng.integers(1, 1 << 62, size=(n - len(keys)) * 2, dtype=np.uint64)
        keys = _sorted_unique(np.concatenate([keys, extra]))
    if len(keys) > n:
        sel = rng.choice(len(keys), size=n, replace=False)
        keys = keys[np.sort(sel)]  # == np.sort(keys[sel]): keys are sorted
    return keys


def gen_amzn(n: int, seed: int = 0) -> np.ndarray:
    """Popularity counts: lognormal body + Pareto tail, scaled to ~2^47."""
    rng = np.random.default_rng(seed)
    m = int(n * 1.25)
    body = rng.lognormal(mean=10.0, sigma=2.2, size=m)
    tail = (rng.pareto(1.1, size=m // 20) + 1.0) * np.exp(14.0)
    raw = np.concatenate([body, tail])
    raw = raw / raw.max() * (2.0**47)
    return _finalize(np.maximum(raw, 1.0), n, rng)


def gen_face(n: int, seed: int = 0) -> np.ndarray:
    """Uniform IDs in (0, 2^50) with ~100 extreme outliers in (2^59, 2^64)."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(1, 1 << 50, size=int(n * 1.05), dtype=np.uint64)
    n_out = 100
    outliers = rng.integers(1 << 59, (1 << 63) + ((1 << 63) - 1), size=n_out,
                            dtype=np.uint64)
    keys = _finalize(raw, n - n_out, rng)
    return np.sort(np.concatenate([keys, _sorted_unique(outliers)]))[:n]


def _hilbert_xy2d(order: int, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Vectorized Hilbert curve distance (uint64), standard xy2d."""
    d = np.zeros(x.shape, np.uint64)
    x = x.astype(np.uint64).copy()
    y = y.astype(np.uint64).copy()
    side = np.uint64(1) << np.uint64(order)
    s = np.uint64(1) << np.uint64(order - 1)
    one = np.uint64(1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.uint64)
        ry = ((y & s) > 0).astype(np.uint64)
        d += s * s * ((np.uint64(3) * rx) ^ ry)
        # rotate quadrant (classic rot(): reflection uses the full side)
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f = np.where(flip, side - one - x, x)
        y_f = np.where(flip, side - one - y, y)
        x, y = np.where(swap, y_f, x_f), np.where(swap, x_f, y_f)
        s >>= one
    return d


def gen_osm(n: int, seed: int = 0, order: int = 24) -> np.ndarray:
    """Hilbert cell ids of clustered 2-D points (cities + background)."""
    rng = np.random.default_rng(seed)
    m = int(n * 1.3)
    n_clusters = 256
    side = float(1 << order)
    cx = rng.uniform(0, side, n_clusters)
    cy = rng.uniform(0, side, n_clusters)
    weights = rng.pareto(1.0, n_clusters) + 0.05
    weights /= weights.sum()
    assign = rng.choice(n_clusters, size=m, p=weights)
    sx = side / 400.0
    x = np.clip(cx[assign] + rng.normal(0, sx, m), 0, side - 1).astype(np.uint64)
    y = np.clip(cy[assign] + rng.normal(0, sx, m), 0, side - 1).astype(np.uint64)
    bg = rng.random(m) < 0.08  # uniform background points
    x[bg] = rng.integers(0, int(side), size=int(bg.sum()), dtype=np.uint64)
    y[bg] = rng.integers(0, int(side), size=int(bg.sum()), dtype=np.uint64)
    d = _hilbert_xy2d(order, x, y)
    return _finalize(d, n, rng)


def gen_wiki(n: int, seed: int = 0) -> np.ndarray:
    """Edit timestamps: exponential gaps, rate modulated daily + bursts."""
    rng = np.random.default_rng(seed)
    m = int(n * 1.15)
    t = np.arange(m, dtype=np.float64)
    rate = 1.0 + 0.8 * np.sin(2 * np.pi * t / 86400.0) ** 2
    burst_at = rng.choice(m, size=m // 200, replace=False)
    burst = np.zeros(m)
    burst[burst_at] = rng.exponential(50.0, size=len(burst_at))
    rate = rate + burst
    gaps = rng.exponential(1.0, size=m) / rate * 1000.0
    ts = np.cumsum(gaps) + 1.0e9
    return _finalize(ts, n, rng)


DATASETS = {
    "amzn": gen_amzn,
    "face": gen_face,
    "osm": gen_osm,
    "wiki": gen_wiki,
}

#: our dataset name -> published SOSD file name (uint64 variants; the
#: format is an 8-byte little-endian count followed by `count` uint64 keys)
SOSD_SOURCES = {
    "amzn": "books_200M_uint64",
    "face": "fb_200M_uint64",
    "osm": "osm_cellids_200M_uint64",
    "wiki": "wiki_ts_200M_uint64",
}


def _sha256(path: str, chunk: int = 1 << 22) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _check_sidecar(path: str) -> None:
    """Verify `path` against a ``<file>.sha256`` sidecar if one exists
    (``sha256sum`` format).  A missing sidecar is accepted; a present one
    that disagrees is corruption and raises."""
    sidecar = path + ".sha256"
    if not os.path.exists(sidecar):
        return
    with open(sidecar) as f:
        tokens = f.read().split()
    if not tokens or len(tokens[0]) != 64:
        raise ValueError(f"malformed sha256 sidecar {sidecar}")
    expected = tokens[0].lower()
    got = _sha256(path)
    if got != expected:
        raise ValueError(
            f"checksum mismatch for {path}: expected {expected}, got {got}")


def load_real(name: str, n: int, sosd_dir: str, seed: int = 0) -> np.ndarray:
    """Load + deterministically subsample one published SOSD binary:
    exactly ``n`` sorted unique uint64 keys at evenly spaced ranks
    (``floor(i * L / n)``).  ``seed`` is accepted for signature parity with
    the surrogates and ignored."""
    del seed
    path = os.path.join(sosd_dir, SOSD_SOURCES[name])
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    _check_sidecar(path)
    with open(path, "rb") as f:
        count = int(np.fromfile(f, dtype="<u8", count=1)[0])
    held = (os.path.getsize(path) - 8) // 8
    if held < count:
        raise ValueError(
            f"{path}: header promises {count} keys, file holds {held}")
    mm = np.memmap(path, dtype="<u8", mode="r", offset=8, shape=(count,))
    keys = _sorted_unique(np.asarray(mm)).astype(np.uint64, copy=False)
    if len(keys) < n:
        raise ValueError(
            f"{path}: only {len(keys)} unique keys, {n} requested")
    if len(keys) == n:
        return keys
    pos = (np.arange(n, dtype=np.float64) * (len(keys) / n)).astype(np.int64)
    return keys[pos]


def generate(name: str, n: int, seed: int = 0) -> np.ndarray:
    """``n`` sorted unique uint64 keys: the real SOSD dataset when
    ``REPRO_SOSD_DIR`` is set and holds the binary, else the surrogate."""
    sosd_dir = os.environ.get("REPRO_SOSD_DIR")
    if sosd_dir:
        try:
            return load_real(name, n, sosd_dir, seed=seed)
        except FileNotFoundError:
            warnings.warn(
                f"REPRO_SOSD_DIR={sosd_dir} has no {SOSD_SOURCES[name]}; "
                f"using the {name} surrogate", stacklevel=2)
    return DATASETS[name](n, seed)


def make_queries(
    keys: np.ndarray,
    m: int,
    seed: int = 0,
    present_frac: float = 0.8,
) -> np.ndarray:
    """Lookup workload: sampled present keys + uniform absent keys (the
    §2 validity definition covers every integer), bit-identical to the
    reference's stream for the same seed."""
    from repro_torch.workloads import make_point_queries

    return make_point_queries(keys, m, seed=seed + 1,
                              present_frac=present_frac, dist="uniform")
