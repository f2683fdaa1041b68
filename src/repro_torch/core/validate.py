"""Validity checking (paper §2): every bound must contain LB(x)."""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core import base, search
from repro_torch.kernels.common import encode_keys


def check_bounds(build: base.IndexBuild, keys: np.ndarray,
                 queries: np.ndarray) -> Dict:
    """Verify lo <= LB(q) <= hi for every query; report bound-width stats."""
    lb = base.lower_bound_oracle(keys, queries)
    lo, hi = build.lookup(build.state, encode_keys(queries, build.device))
    lo = lo.cpu().numpy()
    hi = hi.cpu().numpy()
    ok = (lo <= lb) & (lb <= hi)
    width = np.maximum(hi - lo + 1, 1)
    return {
        "valid": bool(ok.all()),
        "frac_valid": float(ok.mean()),
        "max_width": int(width.max()),
        "avg_width": float(width.mean()),
        "log2_err": float(np.mean(np.log2(width))),
        "n_bad": int((~ok).sum()),
        "bad_idx": np.flatnonzero(~ok)[:8],
    }


def check_end_to_end(
    build: base.IndexBuild,
    keys: np.ndarray,
    queries: np.ndarray,
    last_mile: str = "binary",
) -> Dict:
    """Full lookup (index + last-mile) must produce LB(q) exactly."""
    lb = base.lower_bound_oracle(keys, queries)
    data = encode_keys(keys, build.device)
    q = encode_keys(queries, build.device)
    lo, hi = build.lookup(build.state, q)
    fn = search.SEARCH_FNS[last_mile]
    got = fn(data, q, lo, hi, build.meta["max_err"]).cpu().numpy()
    ok = got == lb
    return {
        "exact": bool(ok.all()),
        "frac_exact": float(ok.mean()),
        "n_bad": int((~ok).sum()),
    }
