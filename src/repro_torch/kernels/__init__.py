"""Hand-written Hopper kernels for the lookup hot path.

  bounded_search/  bounded last-mile lower-bound search (csrc/bounded_search.cu)
  rmi_lookup/      fused two-stage f32 RMI inference (csrc/rmi_lookup.cu)
  pgm_lookup/      a PGM's descent fused with the last mile (csrc/pgm_lookup.cu)

Each kernel package: kernel.py (ctypes binding, launch count), ops.py
(the wrapper: kernel for a CUDA tensor, plain torch version for a CPU
tensor) and, where the plain version needs one, ref.py (plain oracle).
The CUDA sources are built with nvcc at first use (`_build`).
"""
