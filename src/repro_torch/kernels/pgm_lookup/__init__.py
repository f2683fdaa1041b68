from repro_torch.kernels.pgm_lookup.ops import (  # noqa: F401
    PGMState,
    pgm_lookup,
    prepare_state,
)
