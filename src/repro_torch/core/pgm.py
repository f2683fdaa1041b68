"""PGM index (paper §3.3, Ferragina & Vinciguerra [13]).

Bottom-up recursion of error-bounded piecewise linear regressions: level 0
covers the data with error <= eps; each higher level is a PLA over the
anchor keys of the level below with error <= eps_internal, until a level
fits under ``top_cutoff`` segments (searched with one vector rank count).
The fits are the reference's host numpy (`core._pla`).

Lookup descends: at each level the PLA predicts the position of the query's
segment in the level below within a window, and an upper-bound search over
the level's f64 anchors inside the window pins the exact segment.

Validity: the cone bounds ``|pred - rank|`` only at fit points, so each
level's true worst-case error is computed at build time, every fit point
under its own segment and every segment-opening point under the previous
one as well, plus 1 for the gaps between keys.  `_level_error` computes it
with torch ops on the build's device, in the lookup's own op order (the
multiply, then the add, as separate ops), so the bound is the port's own:
XLA on the CPU may contract the reference's into an FMA, and its bounds
can differ by an ulp on a few lanes.  The ranks do not differ.

Two executors run the descent: `descend` as torch ops (the build's
``lookup``: the torch backend, the unfused cuda path and, on the CPU, the
fused kernel's plain version; traced as ``pgm.top``, ``pgm.level{k}``
and ``pgm.leaf``), and on the card the
fused ``pgm_lookup`` kernel (`repro_torch.kernels.pgm_lookup`), which
repeats `descend`'s arithmetic step for step and hands each window to the
bounded search in registers.  The state holds what both read: the levels
(bottom first), each level's verified error ``errs``, the leaf's window
half-width ``e0`` and ``n``.
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import _pla, base, search, spec
from repro_torch.kernels.common import keys_to_f64, resolve_device
from repro_torch.obs.trace import span as trace_span

spec.register_schema(
    "pgm",
    fields=[
        spec.HyperField("eps", int, 64, lo=1, hi=1 << 20),
        spec.HyperField("eps_internal", int, 8, lo=1, hi=1 << 20),
        spec.HyperField("top_cutoff", int, 64, lo=1, hi=1 << 16),
    ],
    # smallest -> largest size: eps controls segment count inversely
    ladder=[dict(eps=e) for e in (2048, 1024, 512, 256, 128, 64, 32, 16, 8)],
)

Level = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _seg_pred(level: Level, seg, qf):
    """A level's prediction for f64 queries in segments ``seg``: the
    lookup's arithmetic."""
    ax, ay, sl = level
    return ay[seg] + sl[seg] * (qf - ax[seg])


def _level_error(level: Level, xs, ys) -> int:
    """Worst |pred - rank| of a PLA level over its own fit points, each
    segment-opening point also under the PREVIOUS segment (the overshoot
    a query approaching the boundary from below can see)."""
    ax = level[0]
    seg = torch.clamp(torch.searchsorted(ax, xs, right=True) - 1,
                      0, ax.shape[0] - 1)
    err = (_seg_pred(level, seg, xs) - ys).abs().max()
    opener = (xs == ax[seg]) & (seg > 0)
    if bool(opener.any()):
        sprev = seg[opener] - 1
        err = torch.maximum(err, (_seg_pred(level, sprev, xs[opener])
                                  - ys[opener]).abs().max())
    return int(np.ceil(float(err)))


def _fit(xu: np.ndarray, y_first: np.ndarray, eps: int, eps_internal: int,
         top_cutoff: int):
    """The reference's segments, bottom level first, as numpy triples."""
    levels = [_pla.shrinking_cone(xu, y_first, float(eps))]
    while len(levels[-1][0]) > top_cutoff:
        lx = levels[-1][0]
        levels.append(_pla.shrinking_cone(
            lx, np.arange(len(lx), dtype=np.float64), float(eps_internal)))
    return levels


def _assemble(n: int, grouped, levels_np: Sequence, hyper: dict,
              dev) -> base.IndexBuild:
    """Verify each level's error through the port's torch arithmetic on
    ``dev`` and wrap the levels as an `IndexBuild`; ``grouped`` is
    `base.grouped_keys` of the ``n`` keys."""
    xu, y_first, span = grouped
    lv: List[Level] = [tuple(torch.from_numpy(np.array(a, np.float64))
                             .to(dev) for a in level)
                       for level in levels_np]
    errs = [_level_error(lv[0], torch.from_numpy(xu).to(dev),
                         torch.from_numpy(y_first).to(dev)) + 1]
    for lvl in range(1, len(lv)):
        lx = lv[lvl - 1][0]
        ly = torch.arange(lx.shape[0], dtype=torch.float64, device=dev)
        errs.append(_level_error(lv[lvl], lx, ly) + 1)  # +1: gap safety
    size = sum(base.nbytes(*level) for level in lv)
    depth = len(lv)
    e0 = errs[0] + span
    return base.IndexBuild(
        name="pgm",
        state={"levels": lv, "errs": tuple(errs), "e0": e0, "n": n},
        lookup=descend,
        size_bytes=size,
        hyper=hyper,
        meta={"max_err": 2 * e0 + 2, "levels": depth, "n": n,
              "segments": lv[0][0].shape[0]},
    )


@functools.lru_cache(maxsize=None)
def _level_span(lvl: int) -> str:
    return f"pgm.level{lvl}"


def descend(state, q) -> base.SearchBound:
    """The descent of encoded queries ``q`` to their data windows ``(lo,
    hi)``: the top level's rank count, each internal level's prediction
    and upper-bound search over the level below's anchors, then level 0's
    prediction widened by ``e0``.  Traced as ``pgm.top``,
    ``pgm.level{k}`` and ``pgm.leaf``."""
    levels, errs, e0, n = state["levels"], state["errs"], state["e0"], \
        state["n"]
    # top level: one vector rank count over <= top_cutoff anchors
    with trace_span("pgm.top"):
        qf = keys_to_f64(q)
        top_x = levels[-1][0]
        seg = (top_x[None, :] <= qf[:, None]).sum(dim=-1) - 1
        seg = torch.clamp(seg, 0, top_x.shape[0] - 1)
    for lvl in range(len(levels) - 1, 0, -1):
        with trace_span(_level_span(lvl)):
            e = errs[lvl]
            below_x = levels[lvl - 1][0]
            m = below_x.shape[0]
            pred = torch.clamp(_seg_pred(levels[lvl], seg, qf),
                               -1.0, float(m) + 1.0)  # int overflow
            lo = torch.clamp(torch.floor(pred).to(torch.int64) - e,
                             0, m - 1)
            hi = torch.clamp(torch.ceil(pred).to(torch.int64) + e,
                             0, m - 1)
            # segment = last anchor <= q  (upper_bound - 1)
            ub = search.bounded_binary(below_x, qf, lo, hi, 2 * e + 3,
                                       side="right")
            seg = torch.clamp(ub - 1, 0, m - 1)
    # level 0 predicts the data position
    with trace_span("pgm.leaf"):
        pred = torch.clamp(_seg_pred(levels[0], seg, qf),
                           -1.0, float(n) + 1.0)  # guard int overflow
        lo = torch.floor(pred).to(torch.int64) - e0
        hi = torch.ceil(pred).to(torch.int64) + e0
        return base.clip_bound(lo, hi, n)


@base.register("pgm")
def build(
    keys: np.ndarray,
    eps: int = 64,
    eps_internal: int = 8,
    top_cutoff: int = 64,
    last_mile: str = "binary",
    device=None,
) -> base.IndexBuild:
    """Fit a PGM over sorted uint64 ``keys`` on the host; verify it on
    ``device`` (None: the CUDA card).  Traced as ``fit.host`` and
    ``fit.verify``."""
    dev = resolve_device(device)
    keys = np.asarray(keys)
    with trace_span("fit.host"):
        grouped = base.grouped_keys(keys)
        levels = _fit(grouped[0], grouped[1], eps, eps_internal, top_cutoff)
    with trace_span("fit.verify"):
        return _assemble(len(keys), grouped, levels,
                         dict(eps=eps, eps_internal=eps_internal,
                              top_cutoff=top_cutoff, last_mile=last_mile),
                         dev)
