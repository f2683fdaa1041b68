"""Error-bounded piecewise-linear fitting (shared by PGM and RadixSpline).

Host numpy, a copy of the reference's fits: the same inputs give the same
segments and knots bit for bit.

``shrinking_cone`` is the O(n) streaming algorithm of Xie et al. [32] used by
PGM (and, with knots restricted to data points, the spline corridor of
Neumann & Michel [25] used by RadixSpline).  The python loop is chunked:
within a chunk, cone slopes are narrowed with vectorized running min/max and
the first violation located with argmax — O(n / chunk) python iterations.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_CHUNK = 8192


def group_rounded(x_f64: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Collapse duplicate (f64-rounded) keys.

    Returns unique keys, the FIRST position of each (lower_bound semantics),
    and the maximum group span, which must be added to any error bound so
    that positions of all collapsed duplicates stay inside it.
    """
    keep = np.empty(len(x_f64), bool)
    keep[0] = True
    np.not_equal(x_f64[1:], x_f64[:-1], out=keep[1:])
    xu = x_f64[keep]
    y_first = y[keep]
    if keep.all():
        return xu, y_first, 0
    # span of each duplicate group = (next group's first index - 1) - first
    starts = np.flatnonzero(keep)
    ends = np.append(starts[1:], len(x_f64)) - 1
    span = int((ends - starts).max())
    return xu, y_first, span


def shrinking_cone(x: np.ndarray, y: np.ndarray, eps: float):
    """Fit y(x) with segments s.t. |pred - y| <= eps for every input point.

    Returns (anchor_x, anchor_y, slope) arrays, one row per segment.  Segment
    i covers x in [anchor_x[i], anchor_x[i+1]).  Prediction inside a segment:
    ``anchor_y + slope * (x - anchor_x)``.
    """
    n = len(x)
    assert n > 0
    ax, ay, slopes = [], [], []
    i = 0
    while i < n:
        xa, ya = x[i], y[i]
        slo, shi = -np.inf, np.inf
        j = i + 1
        # Narrow the cone until it collapses (or data runs out).
        while j < n:
            hi_idx = min(n, j + _CHUNK)
            dx = x[j:hi_idx] - xa  # > 0: duplicates were grouped out
            s_hi = (y[j:hi_idx] + eps - ya) / dx
            s_lo = (y[j:hi_idx] - eps - ya) / dx
            run_hi = np.minimum(np.minimum.accumulate(s_hi), shi)
            run_lo = np.maximum(np.maximum.accumulate(s_lo), slo)
            bad = run_lo > run_hi
            if bad.any():
                k = int(np.argmax(bad))  # first violation in this chunk
                if k == 0:
                    final_lo, final_hi = slo, shi
                else:
                    final_lo, final_hi = run_lo[k - 1], run_hi[k - 1]
                j = j + k
                break
            slo, shi = run_lo[-1], run_hi[-1]
            j = hi_idx
        else:
            final_lo, final_hi = slo, shi

        if not np.isfinite(final_lo):
            final_lo = final_hi if np.isfinite(final_hi) else 0.0
        if not np.isfinite(final_hi):
            final_hi = final_lo
        slope = 0.5 * (final_lo + final_hi)
        ax.append(xa)
        ay.append(float(ya))
        slopes.append(max(float(slope), 0.0))
        i = j if j > i else i + 1

    return (
        np.asarray(ax, np.float64),
        np.asarray(ay, np.float64),
        np.asarray(slopes, np.float64),
    )


def greedy_spline(x: np.ndarray, y: np.ndarray, eps: float):
    """GreedySplineCorridor [25]: like the cone, but knots are DATA points and
    the prediction interpolates between consecutive knots.

    A candidate point c violates if the exact chord slope base->c falls
    outside the corridor narrowed by all points strictly between base and c;
    the point before c then becomes a knot.  Chord-in-corridor implies the
    interpolation error at every interior data point is <= eps.

    Returns (knot_x, knot_y).
    """
    n = len(x)
    knots_x = [x[0]]
    knots_y = [float(y[0])]
    b = 0  # base knot index
    slo, shi = -np.inf, np.inf  # corridor from points (b, j)
    j = 1
    while j < n:
        hi_idx = min(n, j + _CHUNK)
        dx = x[j:hi_idx] - x[b]
        dy = y[j:hi_idx] - y[b]
        s_exact = dy / dx
        s_hi = (dy + eps) / dx
        s_lo = (dy - eps) / dx
        cum_hi = np.minimum.accumulate(s_hi)
        cum_lo = np.maximum.accumulate(s_lo)
        # corridor BEFORE each candidate: carried (slo, shi) + points < it
        prev_hi = np.minimum(np.concatenate([[np.inf], cum_hi[:-1]]), shi)
        prev_lo = np.maximum(np.concatenate([[-np.inf], cum_lo[:-1]]), slo)
        viol = (s_exact > prev_hi) | (s_exact < prev_lo)
        if viol.any():
            m = j + int(np.argmax(viol))  # first violating point; m-1 > b
            knots_x.append(x[m - 1])
            knots_y.append(float(y[m - 1]))
            b = m - 1
            slo, shi = -np.inf, np.inf
            j = b + 1
        else:
            shi = min(shi, float(cum_hi[-1]))
            slo = max(slo, float(cum_lo[-1]))
            j = hi_idx

    if knots_x[-1] != x[n - 1]:
        knots_x.append(x[n - 1])
        knots_y.append(float(y[n - 1]))
    return np.asarray(knots_x, np.float64), np.asarray(knots_y, np.float64)
