"""RadixSpline index (paper §3.2, Kipf et al. [18]).

One-pass error-bounded linear spline over the CDF (the reference's host
numpy, `core._pla.greedy_spline`) plus a radix table over r-bit key
prefixes that bounds the search for the spline segment.  Lookup: radix
probe (a uint64 shift, `kernels.common.radix_prefix`, and two table
loads) -> bounded search over the f64 knots -> linear interpolation ->
a bound of width 2*(e+1).

The spline fit keeps the interpolation error <= eps at every fit point;
``e = eps + span + 1`` adds the widest group of keys that round to one
f64 and the gap between keys.  The reference relies on the corridor for
that and never checks it; the port checks ``|pred - rank| <= e`` over
every key through its own predict on the build's device, and raises if
it fails.

Traced (`repro_torch.obs.trace.span`): the build's ``fit.host`` (the
host fit) and ``fit.verify`` (the radix table and the check), and
`predict`'s ``rs.radix`` (the prefix and the table's loads), ``rs.knots``
(the bounded search over the knots) and ``rs.interp`` (the
interpolation).  `knot_windows` is the knot search's window counter.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import _pla, base, search, spec
from repro_torch.kernels.common import (encode_keys, keys_to_f64,
                                        radix_prefix, resolve_device)
from repro_torch.obs.trace import span as trace_span

spec.register_schema(
    "radix_spline",
    fields=[
        spec.HyperField("eps", int, 32, lo=1, hi=1 << 20),
        spec.HyperField("radix_bits", int, 16, lo=1, hi=28),
    ],
    # smallest -> largest size: eps down (more knots) + radix bits up
    ladder=[dict(eps=e, radix_bits=r)
            for (e, r) in ((1024, 8), (512, 10), (256, 12), (128, 14),
                           (64, 16), (32, 16), (16, 18), (8, 20))],
)

#: keys a chunk of the build-time check
_CHECK_CHUNK = 1 << 24


def radix_shape(keys: np.ndarray, radix_bits: int):
    """``(r, shift)``: the prefix width actually used and the shift that
    takes ``key - kmin`` to it."""
    key_range = int(keys[-1]) - int(keys[0])
    sig_bits = max(1, key_range.bit_length())
    r = int(min(radix_bits, sig_bits))
    return r, sig_bits - r


def knot_windows(state, q):
    """The knots ``[slo, shi]`` (``shi`` inclusive, int64) that the radix
    table leaves `predict` to search for each encoded query: its
    prefix's bucket.  `core.plan.window_counts` reduces them."""
    p = radix_prefix(q, state["kmin"], state["shift"], state["radix_bits"])
    return state["table"][p], state["table"][p + 1]


def predict(state, q):
    """The spline's f64 position of each encoded query: the radix
    bucket's knots, the last knot ``<= q`` among them (upper bound - 1),
    and the interpolation to the next knot.  Traced as ``rs.radix``,
    ``rs.knots`` and ``rs.interp``."""
    kx, ky = state["kx"], state["ky"]
    m = kx.shape[0]
    with trace_span("rs.radix"):
        slo, shi = knot_windows(state, q)
    with trace_span("rs.knots"):
        qf = keys_to_f64(q)
        ub = search.bounded_binary(kx, qf, slo, shi, state["max_gap"] + 2,
                                   side="right")
        seg = torch.clamp(ub - 1, 0, m - 2)
    with trace_span("rs.interp"):
        x0, x1 = kx[seg], kx[seg + 1]
        y0, y1 = ky[seg], ky[seg + 1]
        dx = x1 - x0
        t = torch.where(dx > 0, (qf - x0) / torch.where(dx == 0, 1.0, dx),
                        0.0)
        t = torch.clamp(t, 0.0, 1.0)
        return y0 + t * (y1 - y0)


def _assemble(keys: np.ndarray, kx: np.ndarray, ky: np.ndarray, eps: int,
              radix_bits: int, last_mile: str, span: int,
              dev) -> base.IndexBuild:
    """Radix table over the knots, the bound checked over every key
    through the port's predict on ``dev``, as an `IndexBuild`."""
    n = len(keys)
    m = len(kx)
    kmin = np.uint64(keys[0])
    r, shift = radix_shape(keys, radix_bits)
    # prefixes of the spline KNOTS (knots are data points; recover their
    # uint64 keys from the f64 knots by searchsorted)
    knot_pos = np.searchsorted(base.np_keys_to_f64(keys), kx, side="left")
    knot_keys = keys[np.clip(knot_pos, 0, n - 1)]
    prefixes = ((knot_keys - kmin) >> np.uint64(shift)).astype(np.int64)
    table = np.searchsorted(prefixes, np.arange((1 << r) + 1), side="left")
    table = np.minimum(table, m - 1).astype(np.int64)
    max_gap = int(np.max(table[1:] - table[:-1]))

    state = {
        "kx": torch.from_numpy(np.array(kx, np.float64)).to(dev),
        "ky": torch.from_numpy(np.array(ky, np.float64)).to(dev),
        "table": torch.from_numpy(table).to(dev),
        "kmin": encode_keys(np.array([kmin]), dev)[0],
        "shift": shift,
        "radix_bits": r,
        "max_gap": max_gap,
    }
    size = base.nbytes(state["kx"], state["ky"], state["table"])
    e = int(eps) + span + 1
    max_err = 2 * e + 2

    def lookup(state, q) -> base.SearchBound:
        pred = predict(state, q)
        lo = torch.floor(pred).to(torch.int64) - e
        hi = torch.ceil(pred).to(torch.int64) + e
        return base.clip_bound(lo, hi, n)

    for s in range(0, n, _CHECK_CHUNK):
        chunk = keys[s:s + _CHECK_CHUNK]
        rank = torch.arange(s, s + len(chunk), dtype=torch.float64,
                            device=dev)
        worst = float((predict(state, encode_keys(chunk, dev))
                       - rank).abs().max())
        if worst > e:
            raise ValueError(f"radix_spline: |pred - rank| = {worst} > "
                             f"e = {e} at keys [{s}, {s + len(chunk)})")

    return base.IndexBuild(
        name="radix_spline",
        state=state,
        lookup=lookup,
        size_bytes=size,
        hyper=dict(eps=eps, radix_bits=r, last_mile=last_mile),
        meta={"max_err": max_err, "levels": 2, "n": n, "knots": m,
              "radix_max_gap": max_gap},
    )


@base.register("radix_spline")
def build(
    keys: np.ndarray,
    eps: int = 32,
    radix_bits: int = 16,
    last_mile: str = "binary",
    device=None,
) -> base.IndexBuild:
    """Fit a RadixSpline over sorted uint64 ``keys`` on the host; check
    it on ``device`` (None: the CUDA card).  Traced as ``fit.host`` and
    ``fit.verify``."""
    dev = resolve_device(device)
    keys = np.asarray(keys)
    with trace_span("fit.host"):
        xu, y_first, span = base.grouped_keys(keys)
        kx, ky = _pla.greedy_spline(xu, y_first, float(eps))
        del xu, y_first
    with trace_span("fit.verify"):
        return _assemble(keys, kx, ky, eps, radix_bits, last_mile, span,
                         dev)
