"""Shared helpers for the lookup kernels, and the key codec.

PyTorch has no usable ``uint64`` (no ``<``, ``searchsorted`` or ``>>`` on
the CPU), so the port carries uint64 keys as ``int64`` with the sign bit
flipped: ``k ^ 2^63`` reinterpreted as signed.  That map preserves order
(0 -> INT64_MIN, UINT64_MAX -> INT64_MAX), so every comparison, sort and
``searchsorted`` on the encoded tensor is the uint64 one.

Model inputs are formed from the two uint32 halves: ``f64(hi)*2^32 +
f64(lo)`` rounds once and equals numpy's ``astype(float64)``; the f32
input ``f32(hi)*2^32 + f32(lo)`` is the TPU kernel's own formula
(``repro/kernels/rmi_lookup/ref.py::f32_u``).  Converting the flipped
int64 to float and adding 2^63 would round twice and lose small keys.
"""
from __future__ import annotations

import numpy as np
import torch

SIGN_BIT = 1 << 63
_U32 = 0xFFFFFFFF
_TWO32 = 4294967296.0


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; without one, raise rather than carry
    on silently on the CPU (pass ``device="cpu"`` to ask for it)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


# ---------------------------------------------------------------------------
# Key codec
# ---------------------------------------------------------------------------
def encode_keys(keys, device=None) -> torch.Tensor:
    """uint64 (or narrower unsigned) keys -> order-preserving int64 tensor."""
    a = np.asarray(keys).astype(np.uint64)
    flipped = (a ^ np.uint64(SIGN_BIT)).view(np.int64)
    return torch.from_numpy(flipped).to(resolve_device(device))


def decode_keys(t: torch.Tensor) -> np.ndarray:
    """Inverse of `encode_keys`: int64 tensor -> uint64 numpy array."""
    a = t.detach().cpu().numpy().astype(np.int64, copy=False)
    return a.view(np.uint64) ^ np.uint64(SIGN_BIT)


def key_halves(t: torch.Tensor):
    """Encoded keys -> (hi, lo) uint32 halves of the uint64 key, as int64."""
    hi = ((t >> 32) & _U32) ^ (1 << 31)
    return hi, t & _U32


def keys_to_f64(t: torch.Tensor) -> torch.Tensor:
    """Encoded keys -> float64, rounded once (== numpy ``astype``)."""
    hi, lo = key_halves(t)
    return hi.to(torch.float64) * _TWO32 + lo.to(torch.float64)


def keys_to_f32(t: torch.Tensor) -> torch.Tensor:
    """Encoded keys -> the TPU kernel's f32 input ``f32(hi)*2^32+f32(lo)``."""
    hi, lo = key_halves(t)
    return hi.to(torch.float32) * _TWO32 + lo.to(torch.float32)


# ---------------------------------------------------------------------------
# Ports of repro/kernels/common.py
# ---------------------------------------------------------------------------
def lb_steps(max_width: int) -> int:
    """Fixed trip count covering any bounded window of width <= max_width."""
    return int(np.ceil(np.log2(max(2, int(max_width) + 1)))) + 1


def branchless_lower_bound(data, q, lo, hi, max_width: int,
                           side: str = "left", index_dtype=None):
    """Branchless lower/upper bound in ``[lo, hi]`` (hi INCLUSIVE).

    ``data`` and ``q`` are encoded keys.  The trip count is fixed at
    ``lb_steps(max_width)``; position ``n`` (one past the end) compares as
    +infinity.  Positions are carried in ``index_dtype`` (int64 for the
    last-mile searches, int32 for the bounded-search kernel's plain
    version), with the same floor division the kernel uses.
    """
    n = data.shape[0]
    if index_dtype is None:
        index_dtype = lo.dtype
    lo = lo.to(index_dtype)
    count = torch.clamp((hi + 1 - lo).to(index_dtype), min=0)
    if n == 0:
        return lo
    for _ in range(lb_steps(max_width)):
        step = count // 2
        idx = lo + step
        probe = data[torch.clamp(idx, 0, n - 1).long()]
        go_right = probe < q if side == "left" else probe <= q
        go_right &= idx < n
        lo = torch.where(go_right, lo + step + 1, lo)
        count = torch.where(go_right, count - step - 1, step)
    return lo


def bucket_errors(pred, u, bkt, bkt_mono, n: int,
                  branching: int) -> torch.Tensor:
    """Per-bucket worst ``|pred - rank|`` of a two-stage model, through
    the caller's own ``pred(u, bkt)`` arithmetic, rounded up and capped
    at ``n + 1`` (a bound of +-(n+1) already covers the array): int64
    ``[branching]``.

    Covers every key mapping to the bucket (``bkt``) and both boundary
    keys: the key PRECEDING the bucket's first position (target: that
    first position) and the key FOLLOWING its last one (target: that
    key's position), located on the monotone ``bkt_mono``.  A query in
    the gap between two buckets' keys maps to one of them, so these
    boundary terms make the bound valid for absent keys too.  An empty
    bucket gets both terms at its would-be first position.
    """
    dev = u.device
    err = torch.zeros(branching, dtype=torch.float64, device=dev)
    y = torch.arange(n, dtype=torch.float64, device=dev)
    err.scatter_reduce_(0, bkt.long(), (pred(u, bkt).double() - y).abs(),
                        reduce="amax")
    del y
    j = torch.arange(branching, dtype=torch.int64, device=dev)
    first = torch.searchsorted(bkt_mono, j, side="left")
    after = torch.searchsorted(bkt_mono, j, side="right")
    for probe, target, keep in ((first - 1, first, first > 0),
                                (after, after, after < n)):
        jj = j[keep]
        e = (pred(u[probe[keep]], jj).double()
             - target[keep].double()).abs()
        err[jj] = torch.maximum(err[jj], e)
    return torch.ceil(torch.clamp(err, max=float(n) + 1.0)).to(torch.int64)


def radix_prefix(q, kmin, shift: int, radix_bits: int):
    """Radix buckets of encoded keys: ``(q - kmin) >> shift`` in uint64
    arithmetic (0 where ``q <= kmin``), clipped to ``2^radix_bits - 1``.

    The encoded difference wraps to the bit pattern of the uint64
    difference, which reads negative once that difference is >= 2^63.
    torch's ``>>`` is arithmetic, so the shifted value is masked to a
    logical shift; unshifted, a negative difference lies past every
    bucket."""
    d = torch.where(q > kmin, q - kmin, 0)
    if shift:
        p = (d >> shift) & ((1 << (64 - shift)) - 1)
    else:
        p = torch.where(d < 0, 1 << radix_bits, d)
    return torch.clamp(p, 0, (1 << radix_bits) - 1)
