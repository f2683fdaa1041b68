"""ctypes binding of ``csrc/rmi_lookup.cu`` (f32 RMI bounds, and the
whole lookup fused into one launch).

`launch_bounds` and `launch_lookup` are the only places the two entries
start, and each counts its launches in its own ``.launches``, and by card
in its ``.by_device`` (device name -> launches); a launch captured into a
CUDA graph counts once, at capture, and not at the graph's replays.  Each
ctypes call is traced as ``kernel.launch`` (`repro_torch.obs.trace.span`).
They check what the kernel takes and raise on anything else; choosing
between a kernel and its plain version is `ops`'s job.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.obs.trace import span

_MODEL = [ctypes.c_float] * 6 + [ctypes.c_int, ctypes.c_int]


def _lib():
    lib = _build.load("rmi_lookup")
    p = ctypes.c_void_p
    lib.rmi_bounds.argtypes = [p, ctypes.c_longlong, *_MODEL, p, p, p, p, p,
                               p]
    lib.rmi_lookup.argtypes = [p, ctypes.c_longlong, *_MODEL, p, p, p, p,
                               ctypes.c_longlong, p, p]
    lib.rmi_bounds.restype = lib.rmi_lookup.restype = ctypes.c_int
    return lib


def model_args(state) -> tuple:
    """The f32 model constants in the order the C entries take them."""
    return (state.c0, state.c1, state.x0, state.inv_range, state.scale_f32,
            state.hi_clamp, state.branching, state.n)


def table_ptrs(state) -> tuple:
    """The stage-2 tables' device pointers in the order the C entries take
    them."""
    return state.a2.data_ptr(), state.b2.data_ptr(), state.err.data_ptr()


def _check(state, queries: torch.Tensor) -> None:
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


def launch_bounds(state, queries: torch.Tensor):
    """(lo, hi) int32 bounds for encoded ``queries`` under an
    `ops.F32RMIState` whose tables lie on the queries' CUDA device."""
    _check(state, queries)
    dev, m = queries.device, queries.shape[0]
    lo = torch.empty(m, dtype=torch.int32, device=dev)
    hi = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return lo, hi
    with torch.cuda.device(dev), span("kernel.launch", kernel="rmi_bounds"):
        rc = _lib().rmi_bounds(
            queries.data_ptr(), m, *model_args(state),
            *table_ptrs(state), lo.data_ptr(), hi.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rmi_bounds launch failed: CUDA error {rc}")
    launch_bounds.launches += 1
    by = launch_bounds.by_device
    by[str(dev)] = by.get(str(dev), 0) + 1
    return lo, hi


def launch_lookup(state, data: torch.Tensor, queries: torch.Tensor):
    """int64 LB rank of each encoded query: the bounds, then the search
    over each query's window, in one launch."""
    _check(state, queries)
    if not data.is_cuda or data.device != queries.device \
            or data.dtype != torch.int64 or data.dim() != 1 \
            or not data.is_contiguous() or data.shape[0] != state.n:
        raise ValueError(f"data must be the state's {state.n} encoded keys, "
                         f"contiguous on {queries.device}")
    dev, m = queries.device, queries.shape[0]
    out = torch.empty(m, dtype=torch.int64, device=dev)
    if m == 0:
        return out
    with torch.cuda.device(dev), span("kernel.launch", kernel="rmi_lookup"):
        rc = _lib().rmi_lookup(
            queries.data_ptr(), m, *model_args(state),
            *table_ptrs(state), data.data_ptr(), state.max_err,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rmi_lookup launch failed: CUDA error {rc}")
    launch_lookup.launches += 1
    by = launch_lookup.by_device
    by[str(dev)] = by.get(str(dev), 0) + 1
    return out


launch_bounds.launches = 0
launch_lookup.launches = 0
launch_bounds.by_device = {}
launch_lookup.by_device = {}
