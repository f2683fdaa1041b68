"""The port's bounded last mile (plain version on the CPU) vs the
reference's Pallas op in interpret mode, np.searchsorted and the earlier
design's loop.

Each query searches its own window and stops when it is empty: the
result is the clipped ``lo`` plus the count of keys below ``q`` in the
window, equal to LB wherever the window holds it.  The search probes
near the window's midpoint first (``lookup.cuh``); the balanced loop it
replaced is kept here as an oracle (`_balanced_oracle`).  Tolerance:
exact."""
import re
from pathlib import Path

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
from repro_torch.kernels.bounded_search import ops as bops
from repro_torch.kernels.bounded_search.ops import (clip_windows,
                                                    lower_bound_windows,
                                                    lower_bound_windows_plain,
                                                    search_windows_plain,
                                                    window_probes)
from repro_torch.kernels.bounded_search.ref import lower_bound_windows_ref
from repro_torch.kernels.common import encode_keys


CSRC = Path(kernel.__file__).resolve().parents[2] / "csrc"


def _balanced_oracle(data, queries, lo, max_width, hi=None):
    """The search of the earlier design, step for step: the midpoint of
    what is left while the window is non-empty."""
    n = data.shape[0]
    pos, count = clip_windows(n, lo, max_width, hi)
    for _ in range(min(max(int(max_width), 0), n + 1).bit_length()):
        step = count // 2
        idx = pos + step
        probe = data[torch.clamp(idx, max=n - 1)]
        right = (probe < queries) & (idx < n) & (count > 0)
        pos = torch.where(right, idx + 1, pos)
        count = torch.where(right, count - step - 1, step)
    return pos.to(torch.int32)


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
    d, qt = encode_keys(keys, "cpu"), encode_keys(q, "cpu")
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    oracle = _balanced_oracle(d, qt, lo_t, width, hi_t).numpy()
    np.testing.assert_array_equal(got, oracle)
    for near_blocks in (-1, 0, 1, 3):            # every walk, same count
        np.testing.assert_array_equal(search_windows_plain(
            d, qt, lo_t, width, hi_t, near_blocks).numpy(), oracle)
    # without hi the window is the reference op's [lo, lo + width): the
    # two agree wherever that window holds LB
    lb, start = np.searchsorted(keys, q), np.clip(lo, 0, n - 1)
    holds = (start <= lb) & (lb <= start + width - 1)
    ref = np.asarray(r_lbw(jnp.asarray(keys), jnp.asarray(q),
                           jnp.asarray(start, jnp.int32), max_width=width,
                           interpret=True))
    np.testing.assert_array_equal(
        lower_bound_windows(d, qt, lo_t, width).numpy()[holds], ref[holds])
    np.testing.assert_array_equal(ref[holds], lb[holds])


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
    lo_t = torch.tensor(np.asarray(lo, np.int64), dtype=lo_dtype)
    hi_t = torch.tensor(np.asarray(hi, np.int64), dtype=hi_dtype)
    np.testing.assert_array_equal(got, _balanced_oracle(
        encode_keys(keys, "cpu"), encode_keys(q, "cpu"), lo_t, width,
        hi_t).numpy())
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


@pytest.mark.parametrize("near_blocks", [-1, 0, 1, 2])
@pytest.mark.parametrize("width", [1, 3, 4, 5, 17, 64, 4_096, 4_097, 9_000])
def test_near_midpoint_search_counts_as_the_balanced_loop(width,
                                                          near_blocks):
    """The near-midpoint walk, at every depth, against the earlier loop,
    np.searchsorted and the reference op: windows centred on the answer,
    off it by a few keys, at either end of the window, with duplicate
    keys and UINT64_MAX pad keys, and windows wider than the near search
    takes (4,096 positions)."""
    rng = np.random.default_rng(width * 7 + near_blocks)
    keys = np.sort(np.concatenate([
        rng.integers(0, 2**64 - 1, 6_000, dtype=np.uint64),
        np.repeat(rng.integers(0, 2**64 - 1, 40, dtype=np.uint64), 25),
        np.full(100, 2**64 - 1, np.uint64)]))     # pad keys, as the plan's
    n = len(keys)
    q = np.concatenate([keys[rng.integers(0, n, 3_000)],
                        rng.integers(0, 2**64 - 1, 1_000, dtype=np.uint64),
                        np.array([0, 2**64 - 1], np.uint64)])
    lb = np.searchsorted(keys, q)
    off = np.concatenate([rng.integers(-6, 7, 2_000),
                          rng.integers(-width, width + 1, len(q) - 2_000)])
    mid = lb - off                               # the window's midpoint
    lo = mid - width // 2
    hi = lo + width - 1
    d, qt = encode_keys(keys, "cpu"), encode_keys(q, "cpu")
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    got = search_windows_plain(d, qt, lo_t, width, hi_t, near_blocks)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), _balanced_oracle(d, qt, lo_t, width, hi_t).numpy())
    np.testing.assert_array_equal(got.numpy(),
                                  _count_in_window(keys, q, lo, hi, width))
    holds = (np.clip(lo, 0, n - 1) <= lb) & (lb <= hi)
    np.testing.assert_array_equal(got.numpy()[holds], lb[holds])
    # the reference op's window is [lo, lo + width), without hi: the two
    # agree wherever it holds LB
    start = np.clip(lo, 0, n - 1)
    held = (start <= lb) & (lb <= start + width - 1)
    ref = np.asarray(r_lbw(jnp.asarray(keys), jnp.asarray(q),
                           jnp.asarray(start, jnp.int32), max_width=width,
                           interpret=True))
    np.testing.assert_array_equal(search_windows_plain(
        d, qt, torch.from_numpy(start), width, None,
        near_blocks).numpy()[held], ref[held])
    assert held.sum() > 500


def test_int32_keys_keep_the_balanced_loop():
    """The slot index's int32 keys take no near-midpoint walk: the plain
    version is the earlier loop for them, as the kernel's int32
    instance is."""
    assert bops.NEAR_BLOCKS["bounded_search", torch.int32] == -1
    assert bops.NEAR_BLOCKS["bounded_search", torch.int64] == 0
    rng = np.random.default_rng(5)
    cum = torch.from_numpy(np.cumsum(rng.integers(1, 9, 257)).astype(
        np.int32))
    slots = torch.arange(int(cum[-1]) + 3, dtype=torch.int32)
    lo = torch.zeros_like(slots)
    got = lower_bound_windows_plain(cum, slots, lo, 258)
    np.testing.assert_array_equal(got.numpy(),
                                  np.searchsorted(cum.numpy(), slots.numpy()))
    assert torch.equal(got, _balanced_oracle(cum, slots, lo, 258))


def test_plain_constants_are_the_kernels():
    """`NEAR_MAX`, the sector and each key type's `NEAR_BLOCKS` are the
    constants the CUDA sources compile in."""
    cuh = (CSRC / "lookup.cuh").read_text()
    cu = (CSRC / "bounded_search.cu").read_text()
    assert int(re.search(r"kNearMax = (\d+);", cuh).group(1)) \
        == bops.NEAR_MAX
    assert re.search(r"kSector = (\d+) / sizeof\(KeyT\)", cuh).group(1) \
        == str(bops.SECTOR_BYTES)
    assert re.search(r"kNearBlocks = sizeof\(KeyT\) == 8 \? (-?\d+) : "
                     r"(-?\d+);", cu).groups() \
        == (str(bops.NEAR_BLOCKS["bounded_search", torch.int64]),
            str(bops.NEAR_BLOCKS["bounded_search", torch.int32]))


def _kernel_loop(data, n, q, a, count, near_blocks, unit):
    """``lookup.cuh``'s ``window_lower_bound`` for one query, transcribed
    with its branches and breaks: ``(rank, loads of data)``."""
    loads = 0

    def below(p):
        nonlocal loads
        loads += 1
        return p < n and data[min(p, n - 1)] < q

    b = a + count
    if near_blocks >= 0 and 1 <= count <= bops.NEAR_MAX:
        mid = a + count // 2
        step = unit
        if below(mid):
            a, p = mid + 1, mid | (unit - 1)
            for _ in range(near_blocks + 1):
                if p >= b:
                    break
                if p > mid:
                    if not below(p):
                        b = p
                        break
                    a = p + 1
                p, step = p + step, step * 2
        else:
            b, p = mid, mid & ~(unit - 1)
            for _ in range(near_blocks + 1):
                if p < a:
                    break
                if p < mid:
                    if below(p):
                        a = p + 1
                        break
                    b = p
                if p < step:
                    break
                p, step = p - step, step * 2
    while a < b:
        mid = a + (b - a) // 2
        if below(mid):
            a = mid + 1
        else:
            b = mid
    return a, loads


@pytest.mark.parametrize("near_blocks", [-1, 0, 1, 3])
@pytest.mark.parametrize("dtype", [np.uint64, np.int32])
def test_plain_probes_are_the_kernel_loops_loads(near_blocks, dtype):
    """`search_windows_plain`'s ranks and probes against the kernel's loop
    transcribed one query at a time: windows centred near the answer, off
    it, at the array's ends, empty, and wider than `NEAR_MAX`.  The
    balanced loop makes at most `window_probes` probes."""
    rng = np.random.default_rng(near_blocks + 10)
    if dtype == np.uint64:
        keys = np.sort(rng.integers(0, 2**64 - 1, 9_000, dtype=np.uint64))
        q = np.concatenate([keys[rng.integers(0, 9_000, 300)],
                            rng.integers(0, 2**64 - 1, 100,
                                         dtype=np.uint64)])
        d, qt = encode_keys(keys, "cpu"), encode_keys(q, "cpu")
    else:
        keys = np.cumsum(rng.integers(1, 9, 9_000)).astype(np.int32)
        q = rng.integers(0, int(keys[-1]) + 5, 400).astype(np.int32)
        d, qt = torch.from_numpy(keys), torch.from_numpy(q)
    n = len(keys)
    lb = np.searchsorted(keys, q)
    width = rng.choice([0, 1, 2, 7, 64, 600, 4_096, 6_000], len(q))
    lo = np.clip(lb - width // 2 + rng.integers(-9, 10, len(q)), -5, n + 5)
    lo[:20] = n - 1 - np.arange(20)                  # at the array's end
    hi = lo + width - 1
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    got, probes = search_windows_plain(d, qt, lo_t, 6_000, hi_t, near_blocks,
                                       with_probes=True)
    assert torch.equal(got, search_windows_plain(d, qt, lo_t, 6_000, hi_t,
                                                 near_blocks))
    assert probes.dtype == torch.int64
    start, count = clip_windows(n, lo_t, 6_000, hi_t)
    data, unit = d.tolist(), 32 // d.element_size()
    want = [_kernel_loop(data, n, int(qt[i]), int(start[i]), int(count[i]),
                         near_blocks, unit) for i in range(len(q))]
    np.testing.assert_array_equal(got.numpy(), [r for r, _ in want])
    np.testing.assert_array_equal(probes.numpy(), [k for _, k in want])
    if near_blocks < 0:
        assert (probes <= window_probes(count)).all()
        assert (probes >= window_probes(count) - 1).all()
