"""f32 RMI state preparation, its bounds, and the whole lookup.

``prepare_f32_state`` fits a linear/linear RMI in float64 numpy (as the
reference does) and verifies its stage-2 error table through `ref`'s plain
torch arithmetic, which ``csrc/rmi_lookup.cu`` reproduces bit for bit
(``_rn`` intrinsics, no FMA).  The table is therefore valid for the
kernel, and only for it: it is not the reference's table, whose
verification ran under XLA's FMA contraction.

`rmi_bounds` and `rmi_lookup` send a CUDA tensor to the kernel and a CPU
tensor to their plain versions.  On the card `rmi_lookup` is one launch,
the bounds feeding the bounded search in registers; its plain version is
`rmi_bounds_plain` followed by `lower_bound_windows_plain` over each
query's ``(lo, hi)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.bounded_search.ops import lower_bound_windows_plain
from repro_torch.kernels.common import (bucket_errors, encode_keys,
                                        resolve_device)
from repro_torch.kernels.rmi_lookup import kernel
from repro_torch.kernels.rmi_lookup import ref as _ref


@dataclasses.dataclass
class F32RMIState:
    """f32 model constants (Python floats holding f32 values) and the
    stage-2 table as tensors on one device."""

    c0: float
    c1: float
    x0: float
    inv_range: float
    a2: torch.Tensor        # [B] f32
    b2: torch.Tensor        # [B] f32
    err: torch.Tensor       # [B] int32
    scale: float            # B / n (f64; the arithmetic uses its f32)
    branching: int
    n: int
    max_err: int

    @property
    def scale_f32(self) -> float:
        return float(np.float32(self.scale))

    @property
    def hi_clamp(self) -> float:
        """f32(n + 1), the upper clamp of a prediction."""
        return float(np.float32(float(self.n) + 1.0))


def prepare_f32_state(keys: np.ndarray, branching: int = 4096,
                      device=None) -> F32RMIState:
    """Fit a linear/linear RMI over sorted uint64 ``keys`` and verify its
    error table, on ``device``, through the kernel's f32 arithmetic."""
    dev = resolve_device(device)
    keys = np.asarray(keys).astype(np.uint64)
    n = len(keys)
    if not 0 < n < 2 ** 31:
        raise ValueError(f"n={n} keys: the f32 kernel needs 0 < n < 2^31")
    B = int(branching)
    x = keys.astype(np.float64)
    y = np.arange(n, dtype=np.float64)

    x0 = np.float32(x[0])
    rng = np.float32(x[-1]) - x0
    inv_range = np.float32(1.0 / rng) if rng > 0 else np.float32(1.0)
    scale = B / n

    # stage-1 fit (f64 for conditioning, stored f32)
    u64 = (x - float(x0)) * float(inv_range)
    su, sy = u64.sum(), y.sum()
    suu, suy = (u64 * u64).sum(), (u64 * y).sum()
    denom = n * suu - su * su
    a1 = max((n * suy - su * sy) / denom, 0.0) if denom > 0 else 0.0
    b1 = (sy - a1 * su) / n
    del x, u64

    state = F32RMIState(
        c0=float(np.float32(a1)), c1=float(np.float32(b1)), x0=float(x0),
        inv_range=float(inv_range),
        a2=torch.zeros(1, dtype=torch.float32, device=dev),
        b2=torch.zeros(1, dtype=torch.float32, device=dev),
        err=torch.zeros(1, dtype=torch.int32, device=dev),
        scale=scale, branching=B, n=n, max_err=1,
    )
    # bucket assignment + u through the EXACT kernel-side math
    u_t, bkt_t = _ref.infer_u_bkt(state, encode_keys(keys, dev))
    u32 = u_t.cpu().numpy().astype(np.float64)
    bkt = np.maximum.accumulate(bkt_t.cpu().numpy().astype(np.int64))

    # stage-2 grouped least squares (f64 fit on the f32-rounded u)
    cnt = np.bincount(bkt, minlength=B).astype(np.float64)
    su2 = np.bincount(bkt, weights=u32, minlength=B)
    sy2 = np.bincount(bkt, weights=y, minlength=B)
    suu2 = np.bincount(bkt, weights=u32 * u32, minlength=B)
    suy2 = np.bincount(bkt, weights=u32 * y, minlength=B)
    den2 = cnt * suu2 - su2 * su2
    ok = den2 > 1e-30
    a2 = np.where(ok, (cnt * suy2 - su2 * sy2) / np.where(ok, den2, 1.0), 0.0)
    a2 = np.maximum(a2, 0.0)
    b2 = np.where(cnt > 0, (sy2 - a2 * su2) / np.where(cnt > 0, cnt, 1.0), 0.0)
    first_pos = np.searchsorted(bkt, np.arange(B), side="left").astype(np.float64)
    b2 = np.where(cnt == 0, first_pos, b2)
    del u32, y

    a2f = torch.from_numpy(a2.astype(np.float32)).to(dev)
    b2f = torch.from_numpy(b2.astype(np.float32)).to(dev)
    bkt_d = torch.from_numpy(bkt).to(dev)
    # error verification through the kernel's f32 arithmetic; an empty
    # bucket's model is the constant b2 = first_pos, so its error is the
    # f32 rounding of b2 alone
    # (capped at n+1, which keeps the int32 casts of the bounds safe)
    err_i = (bucket_errors(lambda u, b: _ref.stage2_pred(a2f, b2f, u, b),
                           u_t, bkt_d, bkt_d, n, B) + 1).to(torch.int32)
    return dataclasses.replace(state, a2=a2f, b2=b2f, err=err_i,
                               max_err=int(2 * int(err_i.max()) + 2))


def rmi_bounds_plain(state: F32RMIState, queries):
    """The kernel's bounds as plain torch ops: queries -> (lo, hi)."""
    return _ref.rmi_bounds_ref(state, queries, state.n)


def rmi_bounds(state: F32RMIState, queries):
    """f32 inference: encoded queries -> int32 ``(lo, hi)``, hi inclusive."""
    if queries.device.type == "cpu":
        return rmi_bounds_plain(state, queries)
    return kernel.launch_bounds(state, queries)


def rmi_lookup_plain(state: F32RMIState, data, queries):
    """The fused kernel's function as plain torch ops: the bounds, then
    the search over each query's own window, as int64 ranks."""
    lo, hi = rmi_bounds_plain(state, queries)
    return lower_bound_windows_plain(data, queries, lo, state.max_err,
                                     hi).to(torch.int64)


def rmi_lookup(state: F32RMIState, data, queries):
    """End-to-end: f32 RMI bounds -> bounded last-mile search -> exact LB,
    as int64 ranks; one kernel launch on the card."""
    if queries.device.type == "cpu":
        return rmi_lookup_plain(state, data, queries)
    return kernel.launch_lookup(state, data, queries)
