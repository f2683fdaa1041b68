"""Implicit vector B-tree (the paper's BTree/FAST stand-in), and IBTree.

Each descent step is one gather of a ``fanout + 1`` wide window of a level
and one vector rank count, no pointers.  The size knob is the paper's §2.1
technique, index every s-th key, which bounds the error by exactly s with
no stored error.  Levels are built bottom-up (L0 = keys[::s]; L_{j+1} =
L_j[::fanout]) and held as encoded keys, so every comparison is a plain
int64 one.  Lookup descends coarse -> fine with a ``[B, fanout + 1]``
rank count per level, then maps the sampled position to a width-s bound.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import base, spec
from repro_torch.kernels.common import encode_keys, resolve_device

_BTREE_FIELDS = [
    spec.HyperField("sample", int, 1, lo=1, hi=1 << 20),
    spec.HyperField("fanout", int, 128, lo=2, hi=4096),
]

spec.register_schema(
    "btree",
    fields=_BTREE_FIELDS,
    # smallest -> largest size: coarser sampling = fewer stored keys
    ladder=[dict(sample=s) for s in (1024, 256, 64, 32, 16, 8, 4, 2, 1)],
)

spec.register_schema(
    "ibtree",
    fields=_BTREE_FIELDS,
    ladder=[dict(sample=s) for s in (256, 64, 16, 4, 1)],
)


def _assemble(n: int, levels, s: int, F: int, last_mile: str,
              dev) -> base.IndexBuild:
    """``levels``: uint64 numpy arrays, coarse -> fine."""
    lv = [encode_keys(level, dev) for level in levels]
    depth = len(lv)

    def lookup(state, q) -> base.SearchBound:
        levels = state["levels"]
        # LB within the (<= F wide) root: one vector rank count
        idx = (levels[0][None, :] < q[:, None]).sum(dim=-1)
        offs = torch.arange(F + 1, dtype=torch.int64, device=q.device)
        for child in levels[1:]:
            cn = child.shape[0]
            w = torch.clamp((idx - 1) * F, min=0)
            gidx = w[:, None] + offs[None, :]
            window = child[torch.clamp(gidx, 0, cn - 1)]
            less = (window < q[:, None]) & (gidx < cn)
            idx = w + less.sum(dim=-1)
        lo = torch.clamp((idx - 1) * s + 1, min=0)
        hi = idx * s
        return base.clip_bound(lo, hi, n)

    return base.IndexBuild(
        name="btree",
        state={"levels": lv},
        lookup=lookup,
        size_bytes=sum(base.nbytes(t) for t in lv),
        hyper=dict(sample=s, fanout=F, last_mile=last_mile),
        meta={"max_err": s + 1, "levels": depth, "n": n,
              "root": lv[-1].shape[0]},
    )


@base.register("btree")
def build(
    keys: np.ndarray,
    sample: int = 1,
    fanout: int = 128,
    last_mile: str = "binary",
    device=None,
) -> base.IndexBuild:
    """The sampled levels of sorted uint64 ``keys``, on ``device`` (None:
    the CUDA card)."""
    dev = resolve_device(device)
    keys = np.asarray(keys)
    s = max(1, int(sample))
    F = int(fanout)
    levels = [keys[::s]]
    while len(levels[-1]) > F:
        levels.append(levels[-1][::F])
    return _assemble(len(keys), levels[::-1], s, F, last_mile, dev)


@base.register("ibtree")
def build_ibtree(
    keys: np.ndarray,
    sample: int = 1,
    fanout: int = 128,
    device=None,
    **_,
) -> base.IndexBuild:
    """Interpolating B-tree (paper Table 1, Graefe [15]): the vector
    B-tree's layout and bounds, searched by interpolation in its last
    mile."""
    inner = build(keys, sample=sample, fanout=fanout,
                  last_mile="interpolation", device=device)
    return base.IndexBuild(
        name="ibtree",
        state=inner.state,
        lookup=inner.lookup,
        size_bytes=inner.size_bytes,
        hyper=dict(sample=sample, fanout=fanout, last_mile="interpolation"),
        meta=dict(inner.meta),
    )
