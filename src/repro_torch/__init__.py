"""PyTorch port of the learned-index read path, for NVIDIA Hopper.

Mirrors `repro` (the JAX reference) path for path where a counterpart
exists.  Keys travel as int64 with the sign bit flipped
(`repro_torch.kernels.common.encode_keys`); index state is a dict of
tensors on one device; entry points take ``device=None``, meaning the
CUDA card, and raise without one unless ``device="cpu"`` is asked for.

    from repro_torch.core import plan, spec
    from repro_torch.kernels.common import encode_keys

    build = spec.build(spec.IndexSpec("rmi", {"branching": 4096}), keys)
    p = plan.lower(build, encode_keys(keys))
    ranks = p.compile("cuda")(encode_keys(queries))   # exact LB, int64
"""
