from repro_torch.kernels.rmi_lookup.ops import (  # noqa: F401
    F32RMIState,
    prepare_f32_state,
    rmi_bounds,
    rmi_lookup,
)
