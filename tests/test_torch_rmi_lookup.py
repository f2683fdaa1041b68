"""The port's f32 RMI (plain version on the CPU) vs the reference's Pallas
ops in interpret mode.

Tolerance: LB exact; bounds valid, not necessarily equal.  XLA on the CPU
contracts ``a*u+b`` into an FMA and the port does not, so a few lanes'
``(lo, hi)`` may differ from the reference's; the count is reported.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import sosd as rsosd
from repro.kernels.rmi_lookup import ops as r_ops
from repro.kernels.rmi_lookup import ref as r_ref
from repro_torch.kernels.common import encode_keys
from repro_torch.kernels.rmi_lookup import kernel
from repro_torch.kernels.rmi_lookup import ops, ref

EXTREMES = np.array([0, 1, 2**63, 2**64 - 1], np.uint64)


@pytest.mark.parametrize("branching", [512, 4096])
@pytest.mark.parametrize("ds", ["wiki", "face", "osm"])
def test_rmi_lookup_matches_reference(ds, branching):
    keys = rsosd.generate(ds, 40_000, seed=3)
    q = np.concatenate([rsosd.make_queries(keys, 4_096, seed=5,
                                           present_frac=0.5), EXTREMES])
    lb = np.searchsorted(keys, q)
    st = ops.prepare_f32_state(keys, branching=branching, device="cpu")
    qt = encode_keys(q, "cpu")
    lo, hi = ops.rmi_bounds(st, qt)
    lo, hi = lo.numpy(), hi.numpy()
    assert ((lo <= lb) & (lb <= hi)).all(), "f32 bounds must stay valid"
    assert (hi - lo + 1 <= st.max_err).all()

    rst = r_ops.prepare_f32_state(keys, branching=branching)
    rlo, rhi = r_ops.rmi_bounds(rst, jnp.asarray(q), interpret=True)
    differ = int(((np.asarray(rlo) != lo) | (np.asarray(rhi) != hi)).sum())
    pos = ops.rmi_lookup(st, encode_keys(keys, "cpu"), qt)
    rpos = r_ops.rmi_lookup(rst, jnp.asarray(keys), jnp.asarray(q),
                            interpret=True)
    assert pos.dtype == torch.int32
    assert (pos.numpy() == np.asarray(rpos)).all(), \
        f"LB differs; {differ} of {len(q)} (lo, hi) lanes differ from JAX"
    np.testing.assert_array_equal(pos.numpy(), lb)


def test_model_constants_and_u_match_reference():
    """The f64 numpy fits are the reference's, and u has no FMA to differ
    by: x0, inv_range, c0, c1 and every lane's u are bit-identical."""
    keys = rsosd.generate("amzn", 30_000, seed=9)
    q = rsosd.make_queries(keys, 2_000, seed=10)
    st = ops.prepare_f32_state(keys, branching=1024, device="cpu")
    rst = r_ops.prepare_f32_state(keys, branching=1024)
    for f in ("c0", "c1", "x0", "inv_range"):
        assert getattr(st, f) == float(getattr(rst, f)), f
    assert st.scale == rst.scale and st.n == rst.n
    np.testing.assert_array_equal(
        ref.f32_u(st, encode_keys(q, "cpu")).numpy(),
        np.asarray(r_ref.f32_u(rst, jnp.asarray(q))))


def test_plain_matches_ref_and_verifies_its_own_table():
    keys = rsosd.generate("amzn", 30_000, seed=9)
    st = ops.prepare_f32_state(keys, branching=1024, device="cpu")
    kt = encode_keys(keys, "cpu")
    lo, hi = ops.rmi_bounds_plain(st, kt)
    rlo, rhi = ref.rmi_bounds_ref(st, kt, st.n)
    assert torch.equal(lo, rlo) and torch.equal(hi, rhi)
    # every key's own prediction is within its bucket's stored error
    pred, err, _ = ref.rmi_infer_ref(st, kt)
    gap = (pred.double() - torch.arange(len(keys), dtype=torch.float64)).abs()
    assert (gap <= err.double()).all()


def test_empty_buckets_and_cpu_path_count_no_launch():
    keys = np.arange(1, 501, dtype=np.uint64) * 1000  # B >> n: empty buckets
    st = ops.prepare_f32_state(keys, branching=4096, device="cpu")
    q = np.arange(0, 501_000, 7, dtype=np.uint64)
    before = kernel.launch.launches
    pos = ops.rmi_lookup(st, encode_keys(keys, "cpu"), encode_keys(q, "cpu"))
    assert kernel.launch.launches == before
    np.testing.assert_array_equal(pos.numpy(), np.searchsorted(keys, q))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.launch(st, encode_keys(q, "cpu"))


def test_bounds_without_hi_keep_lo():
    """The fused lookup asks for lo alone; lo is the same either way."""
    keys = rsosd.generate("wiki", 20_000, seed=4)
    q = np.concatenate([rsosd.make_queries(keys, 2_000, seed=6), EXTREMES])
    st = ops.prepare_f32_state(keys, branching=512, device="cpu")
    qt = encode_keys(q, "cpu")
    lo, hi = ops.rmi_bounds(st, qt)
    lo_only, no_hi = ops.rmi_bounds(st, qt, with_hi=False)
    assert no_hi is None and hi is not None
    assert torch.equal(lo_only, lo)


def test_lookup_ref_is_searchsorted():
    keys = rsosd.generate("osm", 5_000, seed=1)
    q = rsosd.make_queries(keys, 1_000, seed=2)
    got = ref.rmi_lookup_ref(encode_keys(keys, "cpu"), encode_keys(q, "cpu"))
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(keys, q))
