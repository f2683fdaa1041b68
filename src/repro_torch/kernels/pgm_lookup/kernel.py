"""ctypes binding of ``csrc/pgm_lookup.cu`` (a PGM's descent and the last
mile in one launch).

`launch_lookup` is the only place the kernel starts; it counts its
launches in ``.launches``, and by card in ``.by_device`` (device name ->
launches); a launch captured into a CUDA graph counts once, at capture,
and not at the graph's replays.  The ctypes call is traced as
``kernel.launch`` (`repro_torch.obs.trace.span`).  It checks what the
kernel takes and raises on anything else; choosing between the kernel and
its plain version is `ops`'s job.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.obs.trace import span

#: ``kMaxDepth`` of the source: the deepest PGM the kernel descends
MAX_DEPTH = 24


class Level(ctypes.Structure):
    """The source's ``Level``: one level's tables and constants."""

    _fields_ = [("ax", ctypes.c_void_p), ("ay", ctypes.c_void_p),
                ("sl", ctypes.c_void_p), ("m", ctypes.c_longlong),
                ("err", ctypes.c_int), ("steps", ctypes.c_int)]


class Model(ctypes.Structure):
    """The source's ``Model``, the kernel's by-value argument."""

    _fields_ = [("level", Level * MAX_DEPTH), ("depth", ctypes.c_int),
                ("n", ctypes.c_longlong), ("e0", ctypes.c_longlong),
                ("max_err", ctypes.c_longlong)]


def _lib():
    lib = _build.load("pgm_lookup")
    p = ctypes.c_void_p
    lib.pgm_lookup.argtypes = [p, ctypes.c_longlong, p, p, p, p]
    lib.pgm_lookup.restype = ctypes.c_int
    return lib


def model_of(state) -> Model:
    """An `ops.PGMState` as the kernel's argument (its device pointers)."""
    st = state.state
    mod = Model(depth=len(st["levels"]), n=st["n"], e0=st["e0"],
                max_err=state.max_err)
    for k, ((ax, ay, sl), err, steps) in enumerate(
            zip(st["levels"], st["errs"], state.steps)):
        mod.level[k] = Level(ax.data_ptr(), ay.data_ptr(), sl.data_ptr(),
                             ax.shape[0], err, steps)
    return mod


def launch_lookup(state, data: torch.Tensor, queries: torch.Tensor):
    """int64 LB rank of each encoded query under an `ops.PGMState` whose
    levels lie on the queries' CUDA device: the descent, then the search
    over each query's window, in one launch."""
    dev = queries.device
    if not queries.is_cuda or queries.dtype != torch.int64 \
            or queries.dim() != 1 or not queries.is_contiguous():
        raise ValueError("queries must be a contiguous int64 CUDA vector")
    at, n = state.state["levels"][0][0].device, state.state["n"]
    if at != dev:
        raise ValueError(f"the state lies on {at}, not {dev}")
    if data.device != dev or data.dtype != torch.int64 or data.dim() != 1 \
            or not data.is_contiguous() or data.shape[0] != n:
        raise ValueError(f"data must be the state's {n} encoded keys, "
                         f"contiguous on {dev}")
    m = queries.shape[0]
    out = torch.empty(m, dtype=torch.int64, device=dev)
    if m == 0:
        return out
    if state.model is None:
        state.model = model_of(state)
    with torch.cuda.device(dev), span("kernel.launch", kernel="pgm_lookup"):
        rc = _lib().pgm_lookup(
            queries.data_ptr(), m, ctypes.addressof(state.model),
            data.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pgm_lookup launch failed: CUDA error {rc}")
    launch_lookup.launches += 1
    by = launch_lookup.by_device
    by[str(dev)] = by.get(str(dev), 0) + 1
    return out


launch_lookup.launches = 0
launch_lookup.by_device = {}
