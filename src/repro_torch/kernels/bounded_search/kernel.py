"""ctypes binding of ``csrc/bounded_search.cu`` (the last-mile kernel).

`launch` is the only place the kernel starts, and counts its launches in
``launch.launches``, and by card in ``launch.by_device`` (device name ->
launches); the ctypes call is traced as ``kernel.launch``
(`repro_torch.obs.trace.span`).  It checks what the kernel takes and
raises on anything else; choosing between the kernel and its plain
version is `ops.lower_bound_windows`'s job.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.obs.trace import span

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_void_p]


def _lib():
    lib = _build.load("bounded_search")
    lib.bounded_search.argtypes = _ARGTYPES
    lib.bounded_search.restype = ctypes.c_int
    return lib


def launch(data: torch.Tensor, queries: torch.Tensor, lo: torch.Tensor,
           max_width: int, hi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32 ``lo + #(keys < q)`` over each query's window
    ``[clip(lo, 0, n-1), min(hi, lo + max_width - 1, n)]``; ``data`` and
    ``queries`` are both int64 (encoded keys) or both int32."""
    n, m = data.shape[0], queries.shape[0]
    named = [("data", data), ("queries", queries), ("lo", lo)]
    if hi is not None:
        named.append(("hi", hi))
    for name, t in named:
        if not t.is_cuda or t.device != data.device:
            raise ValueError(f"{name} must be on the data's CUDA device")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous vector")
    if (data.dtype not in (torch.int32, torch.int64)
            or queries.dtype != data.dtype):
        raise ValueError("data and queries must both be encoded int64 keys "
                         "or both int32")
    for name, t in named[2:]:
        if t.dtype not in (torch.int32, torch.int64) or t.shape[0] != m:
            raise ValueError(f"{name} must be int32 or int64, one per query")
    if not 0 < n < 2 ** 31:
        raise ValueError(f"n={n} must be in [1, 2^31)")
    out = torch.empty(m, dtype=torch.int32, device=data.device)
    if m == 0:
        return out
    with torch.cuda.device(data.device), \
            span("kernel.launch", kernel="bounded_search"):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().bounded_search(
            data.data_ptr(), n, queries.data_ptr(), data.element_size(),
            lo.data_ptr(), lo.element_size(),
            hi.data_ptr() if hi is not None else None,
            hi.element_size() if hi is not None else 0, out.data_ptr(), m,
            int(max_width), stream)
    if rc != 0:
        raise RuntimeError(f"bounded_search launch failed: CUDA error {rc}")
    launch.launches += 1
    by = launch.by_device
    by[str(data.device)] = by.get(str(data.device), 0) + 1
    return out


launch.launches = 0
launch.by_device = {}
