"""The port's bounded last mile (plain version on the CPU) vs the
reference's Pallas op in interpret mode and np.searchsorted."""
import jax

jax.config.update("jax_enable_x64", True)  # uint64 key planes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bounded_search.ops import lower_bound_windows as r_lbw
from repro_torch.kernels.bounded_search import kernel
from repro_torch.kernels.bounded_search.ops import (lower_bound_windows,
                                                    lower_bound_windows_plain)
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
        kernel.launch(d, q, lo, 128, 8)
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
