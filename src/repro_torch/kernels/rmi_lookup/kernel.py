"""ctypes binding of ``csrc/rmi_lookup.cu`` (fused f32 RMI bounds).

`launch` is the only place the kernel starts, and counts its launches in
``launch.launches``.  It checks what the kernel takes and raises on
anything else; choosing between the kernel and its plain version is
`ops.rmi_bounds`'s job.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _lib():
    lib = _build.load("rmi_lookup")
    lib.rmi_bounds.argtypes = _ARGTYPES
    lib.rmi_bounds.restype = ctypes.c_int
    return lib


def launch(state, queries: torch.Tensor, with_hi: bool = True):
    """(lo, hi) int32 bounds for encoded ``queries`` under an
    `ops.F32RMIState` whose tables lie on the queries' CUDA device.
    ``with_hi=False`` returns ``(lo, None)``: the kernel writes no hi."""
    dev = queries.device
    if not queries.is_cuda or queries.dtype != torch.int64 \
            or queries.dim() != 1 or not queries.is_contiguous():
        raise ValueError("queries must be a contiguous int64 CUDA vector")
    for name, t, dt in (("a2", state.a2, torch.float32),
                        ("b2", state.b2, torch.float32),
                        ("err", state.err, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                or t.shape != (state.branching,):
            raise ValueError(f"state.{name} must be a contiguous {dt} "
                             f"[{state.branching}] on {dev}")
    m = queries.shape[0]
    lo = torch.empty(m, dtype=torch.int32, device=dev)
    hi = torch.empty(m, dtype=torch.int32, device=dev) if with_hi else None
    if m == 0:
        return lo, hi
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().rmi_bounds(
            queries.data_ptr(), m, state.c0, state.c1, state.x0,
            state.inv_range, state.scale_f32, state.hi_clamp,
            state.branching, state.n, state.a2.data_ptr(),
            state.b2.data_ptr(), state.err.data_ptr(), lo.data_ptr(),
            hi.data_ptr() if with_hi else None, stream)
    if rc != 0:
        raise RuntimeError(f"rmi_lookup launch failed: CUDA error {rc}")
    launch.launches += 1
    return lo, hi


launch.launches = 0
