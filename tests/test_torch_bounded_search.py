"""The port's bounded last mile (plain version on the CPU) vs the
reference's Pallas op in interpret mode and np.searchsorted.

Each query searches its own window and stops when it is empty: the
result is the clipped ``lo`` plus the count of keys below ``q`` in the
window, equal to LB wherever the window holds it.  Tolerance: exact."""
import jax

jax.config.update("jax_enable_x64", True)  # uint64 key planes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import base as rbase
from repro.core import plan as rplan
from repro.core import search as rsearch
from repro.data import sosd as rsosd
from repro.kernels.bounded_search.ops import lower_bound_windows as r_lbw
from repro_torch.kernels.bounded_search import kernel
from repro_torch.kernels.bounded_search.ops import (clip_windows,
                                                    lower_bound_windows,
                                                    lower_bound_windows_plain,
                                                    window_probes)
from repro_torch.kernels.bounded_search.ref import lower_bound_windows_ref
from repro_torch.kernels.common import encode_keys


def _both(keys, q, lo, width, **ref_kw):
    got = lower_bound_windows(encode_keys(keys, "cpu"),
                              encode_keys(q, "cpu"),
                              torch.from_numpy(lo.astype(np.int32)), width)
    ref = r_lbw(jnp.asarray(keys), jnp.asarray(q),
                jnp.asarray(lo, jnp.int32), max_width=width, interpret=True,
                **ref_kw)
    assert got.dtype == torch.int32
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("n,m,width", [
    (1_000, 257, 64), (10_000, 2_048, 160), (50_000, 4_001, 512),
])
@pytest.mark.parametrize("dtype", [np.uint64, np.uint32])
def test_bounded_search_shapes_dtypes(n, m, width, dtype):
    rng = np.random.default_rng(n + m)
    if dtype == np.uint64:
        keys = np.unique(rng.integers(0, 2**62, int(n * 1.2), dtype=np.uint64))[:n]
    else:
        keys = np.unique(rng.integers(0, 2**31, int(n * 1.3)).astype(np.uint32))[:n]
    q = keys[rng.integers(0, len(keys), m)]
    lb = np.searchsorted(keys, q).astype(np.int64)
    lo = np.maximum(lb - rng.integers(0, width - 1, m), 0)
    got, ref = _both(keys, q, lo, width)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, lb)


def test_bounded_search_all_queries_in_one_tile():
    """Every query in ONE 2048-key tile (the TPU's capacity overflow)."""
    keys = np.arange(10_000, dtype=np.uint64) * 3 + 5
    q = keys[np.random.default_rng(0).integers(0, 100, 5_000)]
    lb = np.searchsorted(keys, q).astype(np.int64)
    lo = np.maximum(lb - 10, 0)
    got, ref = _both(keys, q, lo, 64, capacity=64)
    np.testing.assert_array_equal(got, lb)
    np.testing.assert_array_equal(got, ref)


def test_bounded_search_wide_window():
    """max_width above 2048 (the TPU's wide-window fallback)."""
    keys = np.unique(np.random.default_rng(1).integers(
        0, 2**40, 8_000, dtype=np.uint64))
    q = keys[::3]
    lb = np.searchsorted(keys, q).astype(np.int64)
    lo = np.zeros(len(q), np.int64)
    got, ref = _both(keys, q, lo, len(keys) + 1)
    np.testing.assert_array_equal(got, lb)
    np.testing.assert_array_equal(got, ref)


def test_absent_and_extreme_queries():
    rng = np.random.default_rng(2)
    keys = np.unique(rng.integers(1, 2**64 - 2, 6_000, dtype=np.uint64))
    q = np.concatenate([rng.integers(0, 2**64 - 1, 3_000, dtype=np.uint64),
                        np.array([0, 1, 2**63, 2**64 - 1], np.uint64)])
    lb = np.searchsorted(keys, q).astype(np.int64)
    lo = np.maximum(lb - rng.integers(0, 200, len(q)), 0)
    got, ref = _both(keys, q, lo, 200)
    np.testing.assert_array_equal(got, lb)
    np.testing.assert_array_equal(got, ref)


def test_int64_lo_and_out_of_range_lo_are_clipped():
    keys = np.arange(1, 2_001, dtype=np.uint64) * 2
    q = keys[[0, 5, 1_999]]
    lo = torch.tensor([-7, 3, 5_000], dtype=torch.int64)  # clipped to [0, n-1]
    got = lower_bound_windows(encode_keys(keys, "cpu"), encode_keys(q, "cpu"),
                              lo, 16)
    assert got.tolist() == [0, 5, 1_999]


def test_ref_is_searchsorted():
    keys = np.unique(np.random.default_rng(3).integers(
        0, 2**64 - 1, 4_000, dtype=np.uint64))
    q = np.random.default_rng(4).integers(0, 2**64 - 1, 1_000, dtype=np.uint64)
    got = lower_bound_windows_ref(encode_keys(keys, "cpu"),
                                  encode_keys(q, "cpu"), None, 0)
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(keys, q))


def test_cpu_tensor_never_reaches_the_kernel():
    keys = np.arange(100, dtype=np.uint64)
    d, q = encode_keys(keys, "cpu"), encode_keys(keys[:10], "cpu")
    lo = torch.zeros(10, dtype=torch.int32)
    before = kernel.launch.launches
    lower_bound_windows(d, q, lo, 128)
    assert kernel.launch.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel.launch(d, q, lo, 128)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.launch(d, q, lo, 128, hi=lo)
    assert kernel.launch.launches == before


def test_too_many_keys_for_int32_ranks():
    big = torch.empty(2**31, dtype=torch.int64, device="meta")
    q = torch.empty(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        lower_bound_windows(big, q, q, 8)


def test_plain_on_empty_data():
    got = lower_bound_windows_plain(torch.empty(0, dtype=torch.int64),
                                    torch.zeros(3, dtype=torch.int64),
                                    torch.zeros(3, dtype=torch.int64), 8)
    assert got.tolist() == [0, 0, 0]


def _count_in_window(keys, q, lo, hi, width):
    """numpy oracle: clipped lo + #(keys < q) inside the query's window
    ``[clip(lo, 0, n-1), min(hi, lo + width - 1, n)]``, position n as
    +inf."""
    n = len(keys)
    start = np.clip(lo.astype(np.int64), 0, n - 1)
    last = np.minimum(np.minimum(hi.astype(np.int64), start + width - 1), n)
    real = np.clip(np.minimum(last, n - 1) - start + 1, 0, None)
    return start + np.clip(np.searchsorted(keys, q) - start, 0, real)


def _plain(keys, q, lo, hi, width, lo_dtype=torch.int32,
           hi_dtype=torch.int32):
    return lower_bound_windows(
        encode_keys(keys, "cpu"), encode_keys(q, "cpu"),
        torch.tensor(np.asarray(lo, np.int64), dtype=lo_dtype), width,
        hi=torch.tensor(np.asarray(hi, np.int64), dtype=hi_dtype)).numpy()


@pytest.mark.parametrize("branching", [512, 4096])
@pytest.mark.parametrize("ds", ["amzn", "face", "osm", "wiki"])
def test_per_query_windows_over_the_reference_plans_bounds(ds, branching):
    """The reference RMI plan's own (lo, hi) into the port's search with a
    window per query: equal to np.searchsorted, the reference Pallas op
    (interpret mode) and the reference jnp plan's last mile."""
    keys = rsosd.generate(ds, 8_000, seed=3)
    q = np.concatenate([rsosd.make_queries(keys, 1_000, seed=5,
                                           present_frac=0.7),
                        np.array([0, 1, 2**63, 2**64 - 1], np.uint64)])
    rp = rplan.lower(rbase.REGISTRY["rmi"](keys, branching=branching),
                     jnp.asarray(keys))
    jq = jnp.asarray(q)
    rlo, rhi = rp.bounds.predict(rp.bounds.state, jq)
    w = rp.bounds.max_err
    lo, hi = np.asarray(rlo), np.asarray(rhi)
    got = _plain(keys, q, lo, hi, w, torch.int64, torch.int64)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.searchsorted(keys, q))
    np.testing.assert_array_equal(got, np.asarray(r_lbw(
        jnp.asarray(keys), jq, rlo, max_width=w, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(rsearch.SEARCH_FNS[
        "binary"](jnp.asarray(keys), jq, rlo, rhi, w)))


@pytest.mark.parametrize("width", [1, 2, 7, 64, 5_000])
def test_windows_not_holding_lb_count_inside_the_window(width):
    """Windows placed at random, most of them missing LB: the search stops
    at the empty window, so it returns lo plus the count of keys below q
    in the window (the TPU kernel's count), never a position outside."""
    rng = np.random.default_rng(width)
    keys = np.unique(rng.integers(0, 2**64 - 1, 3_000, dtype=np.uint64))
    n, m = len(keys), 4_000
    q = np.concatenate([keys[rng.integers(0, n, m // 2)],
                        rng.integers(0, 2**64 - 1, m - m // 2,
                                     dtype=np.uint64)])
    lo = rng.integers(-5, n + 5, m)
    hi = lo + rng.integers(-3, width + 3, m)
    got = _plain(keys, q, lo, hi, width)
    np.testing.assert_array_equal(got, _count_in_window(keys, q, lo, hi,
                                                        width))
    start, count = clip_windows(n, torch.from_numpy(lo), width,
                                torch.from_numpy(hi))
    assert ((got >= start.numpy()) & (got <= (start + count).numpy())).all()


@pytest.mark.parametrize("lo_dtype,hi_dtype", [
    (torch.int32, torch.int32), (torch.int32, torch.int64),
    (torch.int64, torch.int32), (torch.int64, torch.int64)])
@pytest.mark.parametrize("case", [
    "width_one", "empty", "hi_below_lo", "hi_at_or_past_n", "lo_past_n"])
def test_window_edge_cases(case, lo_dtype, hi_dtype):
    keys = np.arange(1, 1_001, dtype=np.uint64) * 10   # 10, 20, ..., 10000
    n = len(keys)
    q = np.array([5, 10, 15, 5_000, 9_995, 10_000, 10_001, 2**64 - 1],
                 np.uint64)
    lb = np.searchsorted(keys, q)
    width = 4_096
    lo, hi = {
        "width_one": (lb, lb),                       # hi == lo: one position
        "empty": (lb, np.clip(lb, 0, n - 1) - 1),    # hi == clipped lo - 1
        "hi_below_lo": (lb, lb - 50),
        "hi_at_or_past_n": (np.maximum(lb - 3, 0), lb * 0 + n + 7),
        "lo_past_n": (lb * 0 + n + 3, lb * 0 + n + 9),
    }[case]
    got = _plain(keys, q, lo, hi, width, lo_dtype, hi_dtype)
    np.testing.assert_array_equal(got, _count_in_window(keys, q, lo, hi,
                                                        width))
    if case in ("width_one", "hi_at_or_past_n"):     # windows hold LB
        np.testing.assert_array_equal(got, lb)
    if case in ("empty", "hi_below_lo"):             # nothing is probed
        np.testing.assert_array_equal(got, np.clip(lb, 0, n - 1))


def test_without_hi_the_window_is_lo_plus_max_width():
    """No hi: the window is [lo, lo + max_width), the form of the
    reference op, through the same loop."""
    rng = np.random.default_rng(11)
    keys = np.unique(rng.integers(0, 2**40, 5_000, dtype=np.uint64))
    q = rng.integers(0, 2**40, 3_000, dtype=np.uint64)
    lo = rng.integers(-10, len(keys) + 10, 3_000)
    d, qt = encode_keys(keys, "cpu"), encode_keys(q, "cpu")
    lo_t = torch.from_numpy(lo)
    for width in (1, 33, 300):
        got = lower_bound_windows(d, qt, lo_t, width).numpy()
        far = np.full_like(lo, 2**40)
        np.testing.assert_array_equal(got, _count_in_window(keys, q, lo, far,
                                                            width))
        np.testing.assert_array_equal(
            got, lower_bound_windows(d, qt, lo_t, width,
                                     hi=torch.from_numpy(far)).numpy())


def test_window_probes_is_the_bit_length():
    count = torch.tensor([0, 1, 2, 3, 4, 7, 8, 51, 2**20, 2**31 - 1, 2**31])
    np.testing.assert_array_equal(
        window_probes(count).numpy(),
        [int(c).bit_length() for c in count.tolist()])
