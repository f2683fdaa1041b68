"""The hand-written CUDA kernels against their plain versions, on the card.

Run on a machine with an NVIDIA card:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Elsewhere every test skips: whether a card is present is decided in the
`card` fixture, at run time.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import hashmap, plan, rmi, spec
from repro_torch.data import sosd
from repro_torch.kernels.bounded_search import kernel as bs_kernel
from repro_torch.kernels.bounded_search.ops import (lower_bound_windows,
                                                    lower_bound_windows_plain)
from repro_torch.kernels.common import encode_keys, radix_prefix
from repro_torch.kernels.rmi_lookup import kernel as rmi_kernel
from repro_torch.kernels.rmi_lookup import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


@pytest.mark.parametrize("n,m,width", [
    (1_000, 257, 64), (50_000, 4_001, 512), (1_000_000, 100_000, 300),
    (8_000, 3_000, 8_001),   # wider than the TPU's 2048-key tile
])
@pytest.mark.parametrize("lo_dtype", [torch.int32, torch.int64])
def test_bounded_search_kernel_vs_plain(card, n, m, width, lo_dtype):
    rng = np.random.default_rng(n + m)
    keys = np.unique(rng.integers(0, 2**64 - 1, int(n * 1.1), dtype=np.uint64))[:n]
    q = np.concatenate([keys[rng.integers(0, n, m // 2)],
                        rng.integers(0, 2**64 - 1, m - m // 2, dtype=np.uint64)])
    lb = np.searchsorted(keys, q)
    lo = np.maximum(lb - rng.integers(0, width - 1, m), 0)
    d, qt = encode_keys(keys, card), encode_keys(q, card)
    lo_t = torch.from_numpy(lo).to(card, lo_dtype)
    before = bs_kernel.launch.launches
    got = lower_bound_windows(d, qt, lo_t, width)
    torch.cuda.synchronize()
    assert bs_kernel.launch.launches == before + 1
    plain = lower_bound_windows_plain(d, qt, lo_t, width)
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.cpu().numpy(), lb)


def test_bounded_search_all_queries_in_one_tile(card):
    keys = np.arange(10_000, dtype=np.uint64) * 3 + 5
    q = keys[np.random.default_rng(0).integers(0, 2_048, 50_000)]
    lb = np.searchsorted(keys, q)
    d, qt = encode_keys(keys, card), encode_keys(q, card)
    lo = torch.from_numpy(np.maximum(lb - 10, 0)).to(card)
    got = lower_bound_windows(d, qt, lo, 64)
    assert torch.equal(got, lower_bound_windows_plain(d, qt, lo, 64))
    np.testing.assert_array_equal(got.cpu().numpy(), lb)


@pytest.mark.parametrize("branching", [512, 4096, 2**18])
@pytest.mark.parametrize("ds", ["amzn", "face", "osm", "wiki"])
def test_rmi_kernel_vs_plain(card, ds, branching):
    keys = sosd.generate(ds, 200_000, seed=3)
    q = np.concatenate([sosd.make_queries(keys, 100_000, seed=5),
                        np.array([0, 1, 2**63, 2**64 - 1], np.uint64)])
    st = ops.prepare_f32_state(keys, branching=branching, device=card)
    qt = encode_keys(q, card)
    before = rmi_kernel.launch_bounds.launches
    lo, hi = ops.rmi_bounds(st, qt)
    torch.cuda.synchronize()
    assert rmi_kernel.launch_bounds.launches == before + 1
    plo, phi = ops.rmi_bounds_plain(st, qt)
    assert torch.equal(lo, plo) and torch.equal(hi, phi)
    lb = np.searchsorted(keys, q)
    assert ((lo.cpu().numpy() <= lb) & (lb <= hi.cpu().numpy())).all()
    d = encode_keys(keys, card)
    before = rmi_kernel.launch_lookup.launches
    pos = ops.rmi_lookup(st, d, qt)
    torch.cuda.synchronize()
    assert rmi_kernel.launch_lookup.launches == before + 1
    assert pos.dtype == torch.int64
    assert torch.equal(pos, ops.rmi_lookup_plain(st, d, qt))
    np.testing.assert_array_equal(pos.cpu().numpy(), lb)


@pytest.mark.parametrize("width", [1, 7, 300, 5_000])
@pytest.mark.parametrize("lo_dtype,hi_dtype", [
    (torch.int32, torch.int32), (torch.int64, torch.int32),
    (torch.int32, torch.int64), (torch.int64, torch.int64)])
def test_bounded_search_per_query_hi_vs_plain(card, width, lo_dtype,
                                              hi_dtype):
    """A window per query, half of them holding LB and half placed at
    random (empty, hi < lo, hi >= n, lo > n-1 among them)."""
    rng = np.random.default_rng(width)
    n, m = 200_000, 100_003
    keys = np.unique(rng.integers(0, 2**64 - 1, int(n * 1.1),
                                  dtype=np.uint64))[:n]
    q = np.concatenate([keys[rng.integers(0, n, m // 2)],
                        rng.integers(0, 2**64 - 1, m - m // 2,
                                     dtype=np.uint64)])
    lb = np.searchsorted(keys, q)
    lo = np.maximum(lb - rng.integers(0, width, m), 0)
    hi = lo + rng.integers(0, width, m)
    hi = np.maximum(hi, lb)                    # these hold LB ...
    k = m // 2                                 # ... and these need not
    lo[k:] = rng.integers(-5, n + 5, m - k)
    hi[k:] = lo[k:] + rng.integers(-3, width + 3, m - k)
    d, qt = encode_keys(keys, card), encode_keys(q, card)
    lo_t = torch.from_numpy(lo).to(card, lo_dtype)
    hi_t = torch.from_numpy(hi).to(card, hi_dtype)
    before = bs_kernel.launch.launches
    got = lower_bound_windows(d, qt, lo_t, width, hi=hi_t)
    torch.cuda.synchronize()
    assert bs_kernel.launch.launches == before + 1
    assert torch.equal(got, lower_bound_windows_plain(d, qt, lo_t, width,
                                                      hi_t))
    np.testing.assert_array_equal(got.cpu().numpy()[:k], lb[:k])


def test_plan_backends_on_the_card(card):
    keys = sosd.generate("osm", 300_000, seed=1)
    q = sosd.make_queries(keys, 200_000, seed=2)
    lb = np.searchsorted(keys, q)
    b = rmi.build(keys, branching=4096, device=card)
    p = plan.lower(b, encode_keys(keys, card))
    qt = encode_keys(q, card)
    for fn in (p.compile("cuda"), p.compile("cuda", fused=False),
               p.compile("torch")):
        np.testing.assert_array_equal(fn(qt).cpu().numpy(), lb)
    before = (rmi_kernel.launch_lookup.launches, bs_kernel.launch.launches)
    p.compile("cuda")(qt)                      # fused: one launch a batch
    assert (rmi_kernel.launch_lookup.launches,
            bs_kernel.launch.launches) == (before[0] + 1, before[1])


FAMILIES = [("pgm", {}), ("radix_spline", {}), ("rbs", {}), ("btree", {}),
            ("ibtree", {}), ("binary_search", {}), ("pgm", {"eps": 8}),
            ("btree", {"sample": 16})]


@pytest.mark.parametrize("name,hyper", FAMILIES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(FAMILIES)])
@pytest.mark.parametrize("ds", ["amzn", "face"])
def test_family_plans_on_the_card(card, ds, name, hyper):
    """Built on the card: both backends equal np.searchsorted, and the
    cuda backend is one bounded_search launch a call, no rmi_lookup."""
    keys = sosd.generate(ds, 300_000, seed=1)
    q = np.concatenate([sosd.make_queries(keys, 200_000, seed=2),
                        np.array([0, 1, 2**63, 2**64 - 1], np.uint64),
                        keys[:1] - np.uint64(1), keys[-1:] + np.uint64(1)])
    lb = np.searchsorted(keys, q)
    b = spec.build(spec.IndexSpec(name, hyper), keys, device=card)
    assert b.device.type == "cuda"
    p = plan.lower(b, encode_keys(keys, card))
    qt = encode_keys(q, card)
    before = (rmi_kernel.launch_lookup.launches, bs_kernel.launch.launches)
    got = p.compile("cuda")(qt)
    torch.cuda.synchronize()
    assert (rmi_kernel.launch_lookup.launches,
            bs_kernel.launch.launches) == (before[0], before[1] + 1)
    np.testing.assert_array_equal(got.cpu().numpy(), lb)
    np.testing.assert_array_equal(p.compile("torch")(qt).cpu().numpy(), lb)


def test_robin_hash_on_the_card_launches_nothing(card):
    keys = sosd.generate("wiki", 300_000, seed=1)
    q = sosd.make_queries(keys, 200_000, seed=2)
    b = spec.build(spec.IndexSpec("robin_hash"), keys, device=card)
    p = plan.lower(b, encode_keys(keys, card))
    before = (rmi_kernel.launch_lookup.launches, bs_kernel.launch.launches)
    got = p.compile("cuda")(encode_keys(q, card)).cpu().numpy()
    assert (rmi_kernel.launch_lookup.launches,
            bs_kernel.launch.launches) == before
    pos = {int(k): i for i, k in enumerate(keys)}
    want = np.array([pos.get(int(k), -1) for k in q])
    np.testing.assert_array_equal(got, want)


def test_u64_arithmetic_on_the_card(card):
    """int64 wrapping multiply and the masked shift behave on the card as
    on the CPU, for keys at and above 2^63."""
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**64 - 1, 100_000, dtype=np.uint64, endpoint=True)
    kmin = encode_keys(k[:1], "cpu")[0]
    for bits in (13, 29):
        assert torch.equal(hashmap.hash_slots(encode_keys(k, card), bits).cpu(),
                           hashmap.hash_slots(encode_keys(k, "cpu"), bits))
    for shift in (0, 1, 48):
        assert torch.equal(
            radix_prefix(encode_keys(k, card), kmin.to(card), shift, 16).cpu(),
            radix_prefix(encode_keys(k, "cpu"), kmin, shift, 16))


def test_plan_transforms_on_the_card(card):
    """Scan, merged, merged-scan and instrumented lookups of a PGM plan on
    the card equal the same transforms of the same plan on the CPU."""
    keys = sosd.generate("osm", 300_000, seed=1)
    q = sosd.make_queries(keys, 100_000, seed=2)
    delta = np.setdiff1d(np.random.default_rng(3).integers(
        int(keys[0]), int(keys[-1]), 5_000, dtype=np.uint64), keys)
    padded = np.full(8192, 2**64 - 1, np.uint64)
    padded[:len(delta)] = delta
    plans = {dev: plan.lower(spec.build(spec.IndexSpec("pgm"), keys,
                                        device=dev), encode_keys(keys, dev))
             for dev in (card, torch.device("cpu"))}
    args = {dev: (encode_keys(q, dev), encode_keys(padded, dev))
            for dev in plans}
    n_valid = len(q) - 1_000

    def run(dev):
        p, (qt, dt) = plans[dev], args[dev]
        return [*p.compile_scan(16, "cuda")(qt),
                p.compile_merged("cuda")(qt, dt),
                *p.compile_merged_scan(16, "cuda")(qt, dt),
                *p.compile_instrumented("cuda")(qt, n_valid)]

    before = bs_kernel.launch.launches
    on_card = run(card)
    torch.cuda.synchronize()
    assert bs_kernel.launch.launches == before + 4
    for got, want in zip(on_card, run(torch.device("cpu"))):
        assert torch.equal(got.cpu(), want)
    assert torch.equal(on_card[0].cpu(),
                       torch.from_numpy(np.searchsorted(keys, q)))
