"""Production mesh construction, as the reference's `repro.launch.mesh`.

FUNCTIONS, not module-level constants: importing this module touches no
device and no process group.  A mesh is a `torch.distributed` DeviceMesh
built by `init_device_mesh` over the process group that stands, which
the caller sets up with an explicit address (`tcp://...` or
`file://...`); its device type follows that group's backend (NCCL: the
CUDA cards, gloo: the CPU).  With no process group it raises.
"""
from __future__ import annotations

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W power limit), per
# card: the roofline's compute, memory and link terms
PEAK_FLOPS_BF16 = 989e12       # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12               # device-memory bytes/s
NVLINK_BW = 450e9              # NVLink bytes/s each way


def production_shape(multi_pod: bool = False):
    """``(shape, axes)``: (16, 16) ("data", "model"), or (2, 16, 16) with
    "pod"."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    return make_mesh(*production_shape(multi_pod))


def make_mesh(shape, axes):
    """A mesh of any shape over the standing process group (the elastic
    path: shapes after fault-tolerance re-planning, the train driver's
    (n, 1))."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "torch.distributed.init_process_group with an "
                           "explicit init_method first")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
