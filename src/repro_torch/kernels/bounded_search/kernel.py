"""ctypes binding of ``csrc/bounded_search.cu`` (the last-mile kernel).

`launch` is the only place the kernel starts, and counts its launches in
``launch.launches``.  It checks what the kernel takes and raises on
anything else; choosing between the kernel and its plain version is
`ops.lower_bound_windows`'s job.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = _build.load("bounded_search")
    for fn in (lib.bounded_search_i32, lib.bounded_search_i64):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def launch(data: torch.Tensor, queries: torch.Tensor, lo: torch.Tensor,
           max_width: int, steps: int) -> torch.Tensor:
    """int32 LB per query over ``[clip(lo, 0, n-1), min(lo+max_width, n))``."""
    n, m = data.shape[0], queries.shape[0]
    for name, t in (("data", data), ("queries", queries), ("lo", lo)):
        if not t.is_cuda or t.device != data.device:
            raise ValueError(f"{name} must be on the data's CUDA device")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous vector")
    if data.dtype != torch.int64 or queries.dtype != torch.int64:
        raise ValueError("data and queries must be encoded int64 keys")
    if lo.dtype not in (torch.int32, torch.int64) or lo.shape[0] != m:
        raise ValueError("lo must be int32 or int64, one per query")
    if not 0 < n < 2 ** 31:
        raise ValueError(f"n={n} must be in [1, 2^31)")
    out = torch.empty(m, dtype=torch.int32, device=data.device)
    if m == 0:
        return out
    lib = _lib()
    fn = lib.bounded_search_i32 if lo.dtype == torch.int32 \
        else lib.bounded_search_i64
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(data.data_ptr(), n, queries.data_ptr(), lo.data_ptr(),
                out.data_ptr(), m, int(max_width), int(steps), stream)
    if rc != 0:
        raise RuntimeError(f"bounded_search launch failed: CUDA error {rc}")
    launch.launches += 1
    return out


launch.launches = 0
