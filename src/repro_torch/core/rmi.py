"""Two-stage Recursive Model Index (paper §3.1, Kraska et al. [19]).

Stage 1 (linear | cubic | minmax) makes a coarse CDF prediction that
selects one of B stage-2 linear models; the selected model refines the
prediction, and its stored worst-case error yields the search bound.
The closed-form least-squares fits are the reference's numpy code.

Bucket selection (`_stage1_bucket`) and the stage-2 prediction
(`_stage2_pred`) are torch functions that run on the build's device at
build time AND at lookup time, written as separate multiplies and adds
(no fused op), and the error table is verified through them.  The table
is therefore the port's own: the reference's XLA build contracts
``a*u+b`` into an FMA on the CPU, so its buckets and errors can differ by
an ulp at boundaries.  The lower-bound ranks do not differ.

Validity for ABSENT keys: stage-2 slopes are clipped to >= 0 and each
bucket's error covers every key mapping to it plus the two boundary keys
around it (`kernels.common.bucket_errors`).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import base, spec
from repro_torch.kernels.common import (bucket_errors, encode_keys,
                                        keys_to_f64, resolve_device)
from repro_torch.obs.trace import span

spec.register_schema(
    "rmi",
    fields=[
        spec.HyperField("branching", int, 1024, lo=2, hi=2**22),
        spec.HyperField("stage1", str, "linear",
                        choices=("linear", "cubic", "minmax")),
    ],
    # CDFShop ladder, smallest -> largest size
    ladder=[dict(branching=2**6), dict(branching=2**8),
            dict(branching=2**10), dict(branching=2**10, stage1="cubic"),
            dict(branching=2**12), dict(branching=2**14),
            dict(branching=2**14, stage1="cubic"),
            dict(branching=2**16), dict(branching=2**18)],
)


def _fit_linear(u: np.ndarray, y: np.ndarray):
    """Closed-form least squares y ~ a*u + b (f64)."""
    n = len(u)
    su, sy = u.sum(), y.sum()
    suu, suy = (u * u).sum(), (u * y).sum()
    denom = n * suu - su * su
    if denom <= 0:
        return 0.0, float(y.mean()) if n else 0.0
    a = (n * suy - su * sy) / denom
    b = (sy - a * su) / n
    return float(a), float(b)


def _stage1_bucket(coeffs, x0, inv_range, scale: float, B: int, q):
    """Encoded query/key -> (normalized f64 u, int64 bucket)."""
    u = (keys_to_f64(q) - x0) * inv_range
    p1 = torch.zeros_like(u)
    for i in range(coeffs.shape[0]):
        p1 = p1 * u + coeffs[i]
    bkt = torch.clamp(torch.floor(p1 * scale), 0, B - 1).to(torch.int64)
    return u, bkt


def _stage2_pred(a2, b2, u, bkt):
    """The exact arithmetic the lookup path runs."""
    return a2[bkt] * u + b2[bkt]


def _fit_stage1(stage1: str, u_np: np.ndarray, y: np.ndarray, n: int):
    """Stage-1 coefficients (highest degree first) and the model kept."""
    if stage1 == "linear":
        a, b = _fit_linear(u_np, y)
        return np.array([max(a, 0.0), b], np.float64), stage1
    if stage1 == "cubic":
        coeffs = np.polyfit(u_np, y, 3).astype(np.float64)
        # The absent-key guarantee needs a monotone stage 1: keep the cubic
        # only if its derivative is >= 0 on [0, 1] (endpoints and vertex),
        # else fall back to linear.
        c3, c2, c1_, _ = coeffs
        dvals = [c1_, 3 * c3 + 2 * c2 + c1_]
        if abs(c3) > 1e-30:
            v = -c2 / (3 * c3)
            if 0.0 < v < 1.0:
                dvals.append(3 * c3 * v * v + 2 * c2 * v + c1_)
        if min(dvals) < 0:
            return _fit_stage1("linear", u_np, y, n)
        return coeffs, stage1
    if stage1 == "minmax":
        return np.array([float(n - 1), 0.0], np.float64), stage1
    raise ValueError(f"unknown stage1 model {stage1!r}")


def _assemble(keys: np.ndarray, coeffs, a2, b2, x0: float, inv_range: float,
              B: int, stage1: str, last_mile: str, dev,
              u=None, bkt=None) -> base.IndexBuild:
    """Verify the error table of a fitted model through the port's own
    torch arithmetic on ``dev`` and wrap it as an `IndexBuild`."""
    n = len(keys)
    scale = B / n
    coeffs_t = torch.tensor(np.array(coeffs, np.float64), device=dev)
    x0_t = torch.tensor(float(x0), dtype=torch.float64, device=dev)
    inv_t = torch.tensor(float(inv_range), dtype=torch.float64, device=dev)
    if u is None:
        u, bkt = _stage1_bucket(coeffs_t, x0_t, inv_t, scale, B,
                                encode_keys(keys, dev))
    bkt_mono = bkt if stage1 in ("linear", "minmax") \
        else torch.cummax(bkt, dim=0).values
    a2_t = torch.tensor(np.array(a2, np.float64), device=dev)
    b2_t = torch.tensor(np.array(b2, np.float64), device=dev)
    err_i = bucket_errors(lambda uu, bb: _stage2_pred(a2_t, b2_t, uu, bb),
                          u, bkt, bkt_mono, n, B) + 1  # +1: interior gaps
    max_err = int(err_i.max()) if B else 1

    state: Dict[str, Any] = {"coeffs": coeffs_t, "a2": a2_t, "b2": b2_t,
                             "err": err_i, "x0": x0_t, "inv_range": inv_t}
    size = base.nbytes(coeffs_t, a2_t, b2_t) + 4 * B + 16

    def lookup(state, q) -> base.SearchBound:
        uq, bq = _stage1_bucket(
            state["coeffs"], state["x0"], state["inv_range"], scale, B, q)
        p2 = _stage2_pred(state["a2"], state["b2"], uq, bq)
        # clamp in FLOAT space first: an extreme query (e.g. 2^64-1) can
        # predict ~1e19, which overflows the int64 cast
        p2 = torch.clamp(p2, -1.0, float(n) + 1.0)
        e = state["err"][bq]
        lo = torch.floor(p2).to(torch.int64) - e
        hi = torch.ceil(p2).to(torch.int64) + e
        return base.clip_bound(lo, hi, n)

    return base.IndexBuild(
        name="rmi", state=state, lookup=lookup, size_bytes=size,
        hyper=dict(branching=B, stage1=stage1, last_mile=last_mile),
        meta={"max_err": 2 * max_err + 2, "levels": 2, "n": n},
    )


@base.register("rmi")
def build(
    keys: np.ndarray,
    branching: int = 1024,
    stage1: str = "linear",
    last_mile: str = "binary",
    device=None,
) -> base.IndexBuild:
    """Fit a two-stage RMI over sorted uint64 ``keys``; verify it on
    ``device`` (None: the CUDA card).  Traced as ``fit.host`` (the fit
    with its device bucket assignment) and ``fit.verify``."""
    dev = resolve_device(device)
    keys = np.asarray(keys)
    n = len(keys)
    with span("fit.host"):
        x = base.np_keys_to_f64(keys)
        y = np.arange(n, dtype=np.float64)

        # Normalize keys to [0, 1] for conditioning; constants live in
        # the state.
        x0, x1 = float(x[0]), float(x[-1])
        inv_range = 1.0 / (x1 - x0) if x1 > x0 else 1.0
        u_np = (x - x0) * inv_range
        del x
        coeffs, stage1 = _fit_stage1(stage1, u_np, y, n)
        del u_np

        B = int(branching)
        scale = B / n
        u_t, bkt_t = _stage1_bucket(
            torch.as_tensor(coeffs, device=dev),
            torch.tensor(x0, dtype=torch.float64, device=dev),
            torch.tensor(inv_range, dtype=torch.float64, device=dev),
            scale, B, encode_keys(keys, dev))
        u = u_t.cpu().numpy()       # f64, identical to what lookups compute
        bucket = bkt_t.cpu().numpy()
        bucket_mono = bucket if stage1 in ("linear", "minmax") \
            else np.maximum.accumulate(bucket)

        # ---- stage 2: grouped closed-form least squares ----
        cnt = np.bincount(bucket, minlength=B).astype(np.float64)
        su = np.bincount(bucket, weights=u, minlength=B)
        sy = np.bincount(bucket, weights=y, minlength=B)
        suu = np.bincount(bucket, weights=u * u, minlength=B)
        suy = np.bincount(bucket, weights=u * y, minlength=B)
        denom = cnt * suu - su * su
        ok = denom > 1e-30
        a2 = np.where(ok, (cnt * suy - su * sy) / np.where(ok, denom, 1.0),
                      0.0)
        a2 = np.maximum(a2, 0.0)  # monotone within bucket
        with np.errstate(invalid="ignore"):
            b2 = np.where(cnt > 0,
                          (sy - a2 * su) / np.where(cnt > 0, cnt, 1.0), 0.0)
        # Empty buckets: constant model at the first position of the next
        # non-empty bucket (exact LB for any query landing there).
        first_pos = np.searchsorted(bucket_mono, np.arange(B),
                                    side="left")
        b2 = np.where(cnt == 0, first_pos.astype(np.float64), b2)

    with span("fit.verify"):
        return _assemble(keys, coeffs, a2, b2, x0, inv_range, B, stage1,
                         last_mile, dev, u=u_t, bkt=bkt_t)
