"""Plain torch arithmetic of the fused RMI inference kernel.

Every product and sum is its own torch op, so nothing is contracted into
an FMA: these functions are bit-identical to ``csrc/rmi_lookup.cu``, and
`ops.prepare_f32_state` verifies its error table through them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import keys_to_f32


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def f32_u(state, queries):
    """Encoded query keys -> normalized f32 coordinate."""
    dev = queries.device
    return (keys_to_f32(queries) - _f32(state.x0, dev)) \
        * _f32(state.inv_range, dev)


def infer_u_bkt(state, queries):
    """Stage-1 inference: (u, int32 bucket)."""
    dev = queries.device
    u = f32_u(state, queries)
    p1 = _f32(state.c0, dev) * u + _f32(state.c1, dev)
    bkt = torch.clamp(torch.floor(p1 * _f32(state.scale_f32, dev)),
                      0.0, float(state.branching - 1))
    return u, bkt.to(torch.int32)


def stage2_pred(a2, b2, u, bkt):
    """f32 stage-2 prediction ``a2[bkt]*u + b2[bkt]``, unfused."""
    bkt = bkt.long()
    return a2[bkt] * u + b2[bkt]


def rmi_infer_ref(state, queries):
    """(pred, err, bucket) via plain torch ops."""
    u, bkt = infer_u_bkt(state, queries)
    pred = stage2_pred(state.a2, state.b2, u, bkt)
    return pred, state.err[bkt.long()], bkt


def rmi_bounds_ref(state, queries, n: int):
    pred, err, _ = rmi_infer_ref(state, queries)
    dev = queries.device
    # clamp in float first: guards the int32 casts
    pred = torch.minimum(torch.maximum(pred, _f32(-1.0, dev)),
                         _f32(float(n) + 1.0, dev))
    lo = torch.clamp(torch.floor(pred).to(torch.int32) - err, 0, n)
    hi = torch.clamp(torch.ceil(pred).to(torch.int32) + err, 0, n)
    return lo, hi


def rmi_lookup_ref(data, queries):
    """End-to-end ground truth: exact lower bound."""
    return torch.searchsorted(data, queries, side="left").to(torch.int32)
