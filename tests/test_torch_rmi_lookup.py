"""The port's f32 RMI (plain version on the CPU) vs the reference's Pallas
ops in interpret mode.

Tolerance: LB exact; bounds valid, not necessarily equal.  XLA on the CPU
contracts ``a*u+b`` into an FMA and the port does not, so a few lanes'
``(lo, hi)`` may differ from the reference's; the count is reported.
"""
import re
from pathlib import Path
from types import SimpleNamespace

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
from repro_torch.kernels.bounded_search.ops import NEAR_BLOCKS
from repro_torch.kernels.rmi_lookup import ops, ref
from test_torch_bounded_search import _balanced_oracle

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
    assert pos.dtype == torch.int64       # the rank type plan.compile returns
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
    before = (kernel.launch_bounds.launches, kernel.launch_lookup.launches)
    pos = ops.rmi_lookup(st, encode_keys(keys, "cpu"), encode_keys(q, "cpu"))
    ops.rmi_bounds(st, encode_keys(q, "cpu"))
    assert (kernel.launch_bounds.launches,
            kernel.launch_lookup.launches) == before
    np.testing.assert_array_equal(pos.numpy(), np.searchsorted(keys, q))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.launch_bounds(st, encode_keys(q, "cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.launch_lookup(st, encode_keys(keys, "cpu"),
                             encode_keys(q, "cpu"))


@pytest.mark.parametrize("branching", [512, 4096])
@pytest.mark.parametrize("ds", ["amzn", "face", "osm", "wiki"])
def test_rmi_lookup_plain_matches_reference(ds, branching):
    """The fused kernel's plain version (bounds, then each query's own
    window) equals the reference's rmi_lookup ranks and np.searchsorted."""
    keys = rsosd.generate(ds, 20_000, seed=8)
    q = np.concatenate([rsosd.make_queries(keys, 2_000, seed=9,
                                           present_frac=0.6), EXTREMES])
    st = ops.prepare_f32_state(keys, branching=branching, device="cpu")
    pos = ops.rmi_lookup_plain(st, encode_keys(keys, "cpu"),
                               encode_keys(q, "cpu"))
    rst = r_ops.prepare_f32_state(keys, branching=branching)
    rpos = r_ops.rmi_lookup(rst, jnp.asarray(keys), jnp.asarray(q),
                            interpret=True)
    assert pos.dtype == torch.int64
    np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos))
    np.testing.assert_array_equal(pos.numpy(), np.searchsorted(keys, q))


@pytest.mark.parametrize("entry", ["rmi_bounds", "rmi_lookup"])
def test_binding_passes_model_and_tables_in_the_c_order(entry):
    """The ctypes binding hands the f32 constants and the three stage-2
    tables to each C entry in the order its signature names them."""
    src = (Path(kernel.__file__).resolve().parents[2] / "csrc"
           / "rmi_lookup.cu").read_text()
    sig = re.search(rf"^int {entry}\(([^)]*)\)", src, re.M).group(1)
    names = [a.split()[-1].lstrip("*") for a in sig.split(",")]
    fields = ("c0", "c1", "x0", "inv_range", "scale_f32", "hi_clamp",
              "branching", "n")
    st = SimpleNamespace(**{f: f.replace("_f32", "") for f in fields},
                         **{t: SimpleNamespace(data_ptr=lambda t=t: t)
                            for t in ("a2", "b2", "err")})
    got = (*kernel.model_args(st), *kernel.table_ptrs(st))
    assert names[:2] == ["queries", "m"]
    assert tuple(names[2:2 + len(got)]) == got


def test_lookup_ref_is_searchsorted():
    keys = rsosd.generate("osm", 5_000, seed=1)
    q = rsosd.make_queries(keys, 1_000, seed=2)
    got = ref.rmi_lookup_ref(encode_keys(keys, "cpu"), encode_keys(q, "cpu"))
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(keys, q))


@pytest.mark.parametrize("branching", [512, 4096, 2**18])
@pytest.mark.parametrize("ds", ["amzn", "wiki"])
def test_fused_plain_walks_one_sector_past_the_midpoint(ds, branching):
    """The fused plain version walks its `NEAR_BLOCKS` sectors out from the
    window's midpoint, the RMI's prediction, then searches balanced: the
    same ranks as the earlier loop over the same bounds and as
    np.searchsorted, with queries at the keys, between them and at the
    codec's extremes."""
    keys = rsosd.generate(ds, 30_000, seed=13)
    q = np.concatenate([rsosd.make_queries(keys, 3_000, seed=14,
                                           present_frac=0.5), EXTREMES,
                        keys[:3], keys[-3:]])
    st = ops.prepare_f32_state(keys, branching=branching, device="cpu")
    d, qt = encode_keys(keys, "cpu"), encode_keys(q, "cpu")
    lo, hi = ops.rmi_bounds_plain(st, qt)
    got = ops.rmi_lookup_plain(st, d, qt)
    assert NEAR_BLOCKS["rmi_lookup", torch.int64] == 1
    assert torch.equal(got, _balanced_oracle(d, qt, lo, st.max_err,
                                             hi).to(torch.int64))
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(keys, q))


def test_fused_near_blocks_is_the_kernels():
    src = (Path(kernel.__file__).resolve().parents[2] / "csrc"
           / "rmi_lookup.cu").read_text()
    assert int(re.search(r"constexpr int kNearBlocks = (-?\d+);",
                         src).group(1)) \
        == NEAR_BLOCKS["rmi_lookup", torch.int64]
    assert "window_lower_bound<kNearBlocks>" in src
