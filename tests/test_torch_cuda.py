"""The hand-written CUDA kernels against their plain versions, on the card.

Run on a machine with an NVIDIA card:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Elsewhere every test skips: whether a card is present is decided in the
`card` fixture, at run time.
"""
import gc
import threading
import time
import weakref
from functools import lru_cache

import numpy as np
import pytest
import torch

from repro_torch.core import hashmap, plan, rmi, spec
from repro_torch.data import sosd
from repro_torch.kernels.bounded_search import kernel as bs_kernel
from repro_torch.kernels.bounded_search.ops import (lower_bound_windows,
                                                    lower_bound_windows_plain)
from repro_torch.kernels.common import encode_keys, radix_prefix
from repro_torch.kernels.pgm_lookup import kernel as pgm_kernel
from repro_torch.kernels.pgm_lookup import ops as pgm_ops
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


ORDERS = ("random", "sorted", "reversed", "one_key", "one_region")
# serving buckets (1, 64, 4,096), a block of 256 threads one under, at and
# one over, and a size that is not a multiple of a block
SIZES = (1, 64, 255, 256, 257, 1_001, 4_096)
PAD = 2**64 - 1                       # the plan's pad key (INT64_MAX encoded)


def _ordered(keys, m, order, rng):
    """``m`` queries in one of `ORDERS`: present and absent keys at random,
    the same sorted or reversed, every query on one key, or every query's
    LB inside one 2 MB stretch of the keys."""
    n = len(keys)
    if order == "one_key":
        return np.full(m, keys[n // 3], np.uint64)
    if order == "one_region":
        span = min(n - n // 2, (2 << 20) // 8)
        return keys[n // 2 + rng.integers(0, span, m)]
    q = np.concatenate([keys[rng.integers(0, n, m - m // 4)],
                        rng.integers(0, 2**64 - 1, m // 4, dtype=np.uint64)])
    q[rng.integers(0, m, min(m, 3))] = PAD
    if order == "sorted":
        q = np.sort(q)
    elif order == "reversed":
        q = np.sort(q)[::-1].copy()
    return q


def _count_in_window(keys, q, lo, hi, width):
    n = len(keys)
    start = np.clip(lo, 0, n - 1)
    last = np.minimum(np.minimum(hi, start + width - 1), n)
    real = np.clip(np.minimum(last, n - 1) - start + 1, 0, None)
    return start + np.clip(np.searchsorted(keys, q) - start, 0, real)


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_bounded_search_orders_sizes_and_windows(card, order, m, idx_dtype):
    """B1 over keys ending in pad keys, every query order and serving
    size, with windows centred on LB or off it by a few keys (the near
    search's case), wider than the near search takes (5,000 and 9,000
    positions) and, for a quarter of the queries, placed anywhere (empty,
    hi < lo, lo > n - 1): bit for bit with the plain version, equal to
    np.searchsorted where the window holds LB, one launch."""
    rng = np.random.default_rng(m * 31 + ORDERS.index(order))
    keys = np.concatenate([np.unique(rng.integers(
        0, 2**64 - 2, 300_000, dtype=np.uint64)), np.full(64, PAD,
                                                          np.uint64)])
    n = len(keys)
    q = _ordered(keys, m, order, rng)
    lb = np.searchsorted(keys, q)
    width = 9_000
    half = rng.choice([0, 2, 40, 2_500, 4_500], m)
    lo = lb - half + rng.integers(-6, 7, m)
    hi = lo + 2 * half + rng.integers(0, 3, m)
    k = m - m // 4                      # these windows are placed anywhere
    lo[k:] = rng.integers(-5, n + 5, m - k)
    hi[k:] = lo[k:] + rng.integers(-3, width + 3, m - k)
    d, qt = encode_keys(keys, card), encode_keys(q, card)
    lo_t = torch.from_numpy(lo).to(card, idx_dtype)
    hi_t = torch.from_numpy(np.clip(hi, -2**31, 2**31 - 1)).to(card,
                                                                idx_dtype)
    before = bs_kernel.launch.launches
    got = lower_bound_windows(d, qt, lo_t, width, hi=hi_t)
    torch.cuda.synchronize()
    assert bs_kernel.launch.launches == before + 1
    assert torch.equal(got, lower_bound_windows_plain(d, qt, lo_t, width,
                                                      hi_t))
    got = got.cpu().numpy()
    np.testing.assert_array_equal(got, _count_in_window(
        keys, q, lo, hi_t.cpu().numpy().astype(np.int64), width))
    start = np.clip(lo, 0, n - 1)
    holds = (start <= lb) & (lb <= np.minimum(hi, start + width - 1))
    np.testing.assert_array_equal(got[holds], lb[holds])


@lru_cache(maxsize=None)
def _fused_cell(ds, branching):
    keys = sosd.generate(ds, 300_000, seed=17)
    return keys, ops.prepare_f32_state(keys, branching=branching,
                                       device="cuda")


@pytest.mark.parametrize("m", [1, 64, 257, 4_096, 4_097])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("branching", [512, 4096, 2**18])
def test_fused_lookup_orders_and_sizes(card, branching, order, m):
    """The fused kernel over every query order and serving size, on amzn
    (wide windows) at 512 models and wiki (narrow) otherwise: bit for bit
    with its plain version and np.searchsorted, one launch."""
    ds = "amzn" if branching == 512 else "wiki"
    keys, st = _fused_cell(ds, branching)
    rng = np.random.default_rng(m + branching)
    q = _ordered(keys, m, order, rng)
    d, qt = encode_keys(keys, card), encode_keys(q, card)
    before = rmi_kernel.launch_lookup.launches
    pos = ops.rmi_lookup(st, d, qt)
    torch.cuda.synchronize()
    assert rmi_kernel.launch_lookup.launches == before + 1
    assert torch.equal(pos, ops.rmi_lookup_plain(st, d, qt))
    np.testing.assert_array_equal(pos.cpu().numpy(), np.searchsorted(keys, q))


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


def test_fused_lookup_shows_one_kernel_under_its_launch_span(card, tmp_path):
    """Under the profiler one call of the fused lookup shows exactly one
    kernel, whose runtime launch (matched by its correlation) lies inside
    the port's ``kernel.launch`` span, itself inside ``lookup``, on the
    launching thread: the port's spans on the device trace's clock."""
    import json

    from torch.profiler import ProfilerActivity, profile

    keys = sosd.generate("wiki", 300_000, seed=1)
    q = sosd.make_queries(keys, 200_000, seed=2)
    qt = encode_keys(q, card)
    fn = plan.lower(rmi.build(keys, branching=4096, device=card),
                    encode_keys(keys, card)).compile("cuda")
    fn(qt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn(qt)
        torch.cuda.synchronize()
    np.testing.assert_array_equal(out.cpu().numpy(), np.searchsorted(keys, q))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    events = [e for e in (doc["traceEvents"] if isinstance(doc, dict)
                          else doc) if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert len(kernels) == 1 and "rmi_lookup" in kernels[0]["name"]
    corr = kernels[0]["args"]["correlation"]
    launch = [e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and (e.get("args") or {}).get("correlation") == corr]
    assert len(launch) == 1
    at, tid = float(launch[0]["ts"]), launch[0]["tid"]

    def open_at(name):
        return [e for e in events if e.get("cat") == "user_annotation"
                and e["name"] == name and e["tid"] == tid
                and float(e["ts"]) <= at <= float(e["ts"]) + float(e["dur"])]

    (span,), (call,) = open_at("kernel.launch"), open_at("lookup")
    assert float(call["ts"]) <= float(span["ts"])
    assert float(span["ts"]) + float(span["dur"]) \
        <= float(call["ts"]) + float(call["dur"])


#: (dataset, hyper, depth) of the fused PGM kernel's card tests on 2M
#: keys: depths 1 to 6, and a top level of 10,428 anchors, far past the
#: default ``top_cutoff`` of 64 (the schema allows 2^16)
PGM_CASES = [("wiki", {"eps": 64, "top_cutoff": 2 ** 16}, 1),
             ("wiki", {"eps": 8, "top_cutoff": 2 ** 16}, 1),
             ("wiki", {"eps": 64}, 2),
             ("wiki", {"eps": 8, "eps_internal": 2, "top_cutoff": 16}, 3),
             ("amzn", {"eps": 8, "eps_internal": 2, "top_cutoff": 16}, 3),
             ("wiki", {"eps": 8, "eps_internal": 2, "top_cutoff": 2}, 4),
             ("amzn", {"eps": 16, "eps_internal": 2, "top_cutoff": 4}, 4),
             ("wiki", {"eps": 4, "eps_internal": 1, "top_cutoff": 4}, 5),
             ("amzn", {"eps": 2, "eps_internal": 1, "top_cutoff": 2}, 6)]


@lru_cache(maxsize=None)
def _pgm_keys(ds):
    return sosd.generate(ds, 2_000_000, seed=1)


def _pgm_plan(card, ds, hyper):
    keys = _pgm_keys(ds)
    b = spec.build(spec.IndexSpec("pgm", hyper), keys, device=card)
    return keys, plan.lower(b, encode_keys(keys, card))


def _pgm_plain(st, data, qt, chunk=1 << 17):
    """`pgm_lookup_plain` a chunk at a time: its top level is a
    [queries x top anchors] compare."""
    return torch.cat([pgm_ops.pgm_lookup_plain(st, data, qt[i:i + chunk])
                      for i in range(0, qt.shape[0], chunk)])


@pytest.mark.parametrize("ds,hyper,depth", PGM_CASES,
                         ids=[f"{ds}-depth{d}-{i}"
                              for i, (ds, _, d) in enumerate(PGM_CASES)])
def test_pgm_kernel_vs_plain(card, ds, hyper, depth):
    """The fused PGM kernel equals its plain version (the torch descent,
    then B1's plain search) on every lane of 4M queries, and
    np.searchsorted; one launch a call.  With every error narrowed to 0
    the windows miss their answers, and the two still agree."""
    keys, p = _pgm_plan(card, ds, hyper)
    assert len(p.bounds.state["levels"]) == depth
    rng = np.random.default_rng(depth)
    q = np.concatenate([
        sosd.make_queries(keys, 3_000_000, seed=2),
        rng.integers(0, 2**64 - 1, 1_000_000, np.uint64, endpoint=True),
        np.array([0, 1, 2**53 + 1, 2**63, 2**64 - 1], np.uint64)])
    qt = encode_keys(q, card)
    fn = p.compile("cuda")
    st = p._cache["_pgm_state"]
    if depth == 1 and hyper["eps"] == 8:
        assert st.state["levels"][-1][0].shape[0] > 4096  # a wide top
    before = _counts()
    got = fn(qt)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == [0, 0, 0, 1]
    assert torch.equal(got, _pgm_plain(st, p.data, qt))
    np.testing.assert_array_equal(got.cpu().numpy(), np.searchsorted(keys, q))
    state = p.bounds.state
    narrow = pgm_ops.prepare_state(
        dict(state, errs=(0,) * len(state["errs"]), e0=0), p.bounds.max_err)
    got = pgm_ops.pgm_lookup(narrow, p.data, qt)
    assert torch.equal(got, _pgm_plain(narrow, p.data, qt))
    assert (got.cpu().numpy() != np.searchsorted(keys, q)).any()


def test_pgm_lookup_is_one_launch_under_its_span(card):
    """One call of the fused PGM lookup: one ``kernel.launch`` span with
    ``kernel="pgm_lookup"`` inside ``lookup``, no ``pgm.*`` span, and
    ``launch_lookup.launches`` up by one."""
    from repro_torch.obs import trace

    keys, p = _pgm_plan(card, "wiki", {"eps": 64})
    q_host = sosd.make_queries(keys, 200_000, seed=2)
    q = encode_keys(q_host, card)
    fn = p.compile("cuda")
    fn(q)
    rec = trace.SpanRecorder()
    before = pgm_kernel.launch_lookup.launches
    with trace.recording(rec):
        out = fn(q)
    torch.cuda.synchronize()
    assert pgm_kernel.launch_lookup.launches == before + 1
    spans = rec.spans()
    assert [s.name for s in spans] == ["kernel.launch", "lookup"]
    assert spans[0].args == {"kernel": "pgm_lookup"}
    assert spans[1].t0 <= spans[0].t0 \
        and spans[0].t0 + spans[0].dur <= spans[1].t0 + spans[1].dur
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  np.searchsorted(keys, q_host))


def test_pgm_lookup_graph_replay_equals_eager(card):
    """The fused PGM lookup captured as a CUDA graph (no host sync or
    host-to-device copy inside the call) replays to the eager answers,
    for the batch it captured and for new queries copied into its input."""
    keys, p = _pgm_plan(card, "wiki", {"eps": 64})
    fn = p.compile("cuda")
    q0 = encode_keys(sosd.make_queries(keys, 1 << 20, seed=4), card)
    q1 = encode_keys(sosd.make_queries(keys, 1 << 20, seed=5), card)
    static = q0.clone()
    fn(static)                           # the state exists before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = pgm_kernel.launch_lookup.launches
    with torch.cuda.graph(graph):
        out = fn(static)
    assert pgm_kernel.launch_lookup.launches == before + 1
    for q in (q0, q1):
        static.copy_(q)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fn(q))
    assert pgm_kernel.launch_lookup.launches == before + 3


FAMILIES = [("pgm", {}), ("radix_spline", {}), ("rbs", {}), ("btree", {}),
            ("ibtree", {}), ("binary_search", {}), ("pgm", {"eps": 8}),
            ("btree", {"sample": 16})]


@pytest.mark.parametrize("name,hyper", FAMILIES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(FAMILIES)])
@pytest.mark.parametrize("ds", ["amzn", "face"])
def test_family_plans_on_the_card(card, ds, name, hyper):
    """Built on the card: both backends equal np.searchsorted, and the
    cuda backend is one launch a call: PGM's fused pgm_lookup, every other
    family's bounded_search, no rmi_lookup."""
    keys = sosd.generate(ds, 300_000, seed=1)
    q = np.concatenate([sosd.make_queries(keys, 200_000, seed=2),
                        np.array([0, 1, 2**63, 2**64 - 1], np.uint64),
                        keys[:1] - np.uint64(1), keys[-1:] + np.uint64(1)])
    lb = np.searchsorted(keys, q)
    b = spec.build(spec.IndexSpec(name, hyper), keys, device=card)
    assert b.device.type == "cuda"
    p = plan.lower(b, encode_keys(keys, card))
    qt = encode_keys(q, card)
    before = _counts()
    got = p.compile("cuda")(qt)
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_counts(), before)]
    assert launched == ([0, 0, 0, 1] if name == "pgm" else [0, 0, 1, 0])
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

    before = _counts()
    on_card = run(card)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == [0, 0, 0, 4]
    for got, want in zip(on_card, run(torch.device("cpu"))):
        assert torch.equal(got.cpu(), want)
    assert torch.equal(on_card[0].cpu(),
                       torch.from_numpy(np.searchsorted(keys, q)))


# ---------------------------------------------------------------------------
# serving and tuning on the card
# ---------------------------------------------------------------------------
def _counts():
    return (rmi_kernel.launch_lookup.launches, rmi_kernel.launch_bounds.launches,
            bs_kernel.launch.launches, pgm_kernel.launch_lookup.launches)


@pytest.mark.parametrize("index", ["rmi", "pgm"])
def test_lookup_service_on_the_card(card, index):
    from repro_torch.serve.lookup import (LookupService, LookupServiceConfig,
                                          default_spec)

    keys = sosd.generate("amzn", 200_000, seed=3)
    q = sosd.make_queries(keys, 20_000, seed=4)
    cfgs = {be: LookupServiceConfig(spec=default_spec(index, backend=be),
                                    max_batch=2048, trace=True)
            for be in ("cuda", "torch")}
    gpu = LookupService(keys, cfgs["cuda"], device=card)
    cpu = LookupService(keys, cfgs["torch"], device="cpu")
    before = _counts()
    results = {}
    for svc in (gpu, cpu):
        futs = [svc.submit(q[i:i + 500]) for i in range(0, 10_000, 500)]
        futs += [svc.scan(q[i:i + 100], 16) for i in range(10_000, 12_000,
                                                             100)]
        svc.drain()
        results[svc] = [f.result(30) for f in futs]
    after = _counts()
    for a, b in zip(results[gpu], results[cpu]):
        if isinstance(a, tuple):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[1].dtype == np.uint64
        else:
            np.testing.assert_array_equal(a, b)
    got = np.concatenate(results[gpu][:20])
    np.testing.assert_array_equal(got, np.searchsorted(keys, q[:10_000]))
    batches = gpu.metrics.snapshot()["batches"]
    launched = [a - b for a, b in zip(after, before)]
    want = [batches, 0, 0, 0] if index == "rmi" else [0, 0, 0, batches]
    assert launched == want
    assert gpu.health_snapshot()["health_n"] == 10_000
    assert gpu.check_alerts() == [] and gpu.alerts.firing() == []


def test_staging_buffer_reuse_under_in_flight_copies(card):
    """Back-to-back batches of one bucket, each launched before the last
    finished: the next pad into the bucket's pinned buffer must wait for
    the copy out of it, so every batch answers for its own keys.  A spin
    kernel queued before each batch keeps the stream busy, so every copy
    is still pending when the next batch pads into the buffer (without
    the dispatcher's wait on its copy event, the batches read each
    other's keys)."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.serve.lookup import ShardedDispatcher

    keys = sosd.generate("wiki", 500_000, seed=1)
    b = spec.build(spec.IndexSpec("rmi", {"branching": 4096}), keys,
                   device=card)
    fn = plan_mod.lower(b, encode_keys(keys, card)).compile("cuda")
    d = ShardedDispatcher(device=card)
    rng = np.random.default_rng(0)
    batches = [sosd.make_queries(keys, int(rng.integers(2049, 4097)), seed=i)
               for i in range(200)]
    outs = []
    for q in batches:
        torch.cuda._sleep(1_000_000)     # ~0.5 ms of stream time
        (qt,), p = d.pad_and_place(q)
        assert p == 4096
        outs.append(fn(qt))              # no wait between batches
    torch.cuda.synchronize()
    assert d.staging_allocs == 1 and d.staging_hits == 199
    for q, out in zip(batches, outs):
        np.testing.assert_array_equal(out[:q.size].cpu().numpy(),
                                      np.searchsorted(keys, q))


def test_tuner_measures_both_backends_on_the_card(card):
    from repro_torch.core import plan as plan_mod

    keys = sosd.generate("osm", 100_000, seed=2)
    res = spec.Tuner(max_bytes=1 << 16, backends=("torch", "cuda"),
                     max_configs=2).tune(keys, device=card)
    assert set(res.backend_ns) == {"torch", "cuda"}
    assert res.spec.backend == min(res.backend_ns, key=res.backend_ns.get)
    assert res.build.size_bytes <= 1 << 16
    assert res.build.device.type == "cuda"
    q = sosd.make_queries(keys, 50_000, seed=3)
    p = plan_mod.lower(res.build, encode_keys(keys, card))
    got = p.compile(res.spec.backend)(encode_keys(q, card))
    np.testing.assert_array_equal(got.cpu().numpy(), np.searchsorted(keys, q))


# ---------------------------------------------------------------------------
# the async executor's CUDA graphs, and the mutable service, on the card
# ---------------------------------------------------------------------------
def _graph_cell(card, index):
    """A generation of ``index`` at its serving defaults on the cuda
    backend, its host keys, and a delta of absent keys on the card."""
    from repro_torch.mutable.delta import DeltaBuffer
    from repro_torch.serve.lookup import IndexRegistry, default_spec

    keys = sosd.generate("osm", 300_000, seed=1)
    gen = IndexRegistry(device=card).build_and_publish(
        default_spec(index, backend="cuda"), keys)
    rng = np.random.default_rng(7)
    cand = np.unique(rng.integers(int(keys[0]), int(keys[-1]), 3_000,
                                  dtype=np.uint64))
    fresh = np.setdiff1d(cand, keys)[:2_000]
    delta, _ = DeltaBuffer.empty(device=card).with_inserted(keys, fresh)
    return keys, gen, delta


_GRAPH_KINDS = ("plain", "instrumented", "scan", "merged",
                "merged_instrumented", "merged_scan")


def _graph_fn(gen, delta, kind):
    """(callable, bind, instrumented) of one executable kind."""
    p, be = gen.plan, gen.backend
    return {
        "plain": (gen.fn, (), False),
        "instrumented": (gen.instrumented_fn(), (), True),
        "scan": (gen.scan_fn(16), (), False),
        "merged": (p.compile_merged(be), (delta.device,), False),
        "merged_instrumented": (gen.instrumented_merged_fn(),
                                (delta.device,), True),
        "merged_scan": (p.compile_merged_scan(16, be), (delta.device,),
                        False),
    }[kind]


@pytest.mark.parametrize("index", ["rmi", "pgm"])
@pytest.mark.parametrize("kind", _GRAPH_KINDS)
def test_graph_replay_equals_eager_on_every_warmed_bucket(card, index, kind):
    """Each executable kind, captured for every warm bucket (128 ..
    4096), replays to exactly what the eager callable returns on the same
    padded batch, launches the path's one kernel once a replay, and the
    dispatcher's launch/complete halves give the eager answers."""
    from repro_torch.serve.lookup import ShardedDispatcher
    from repro_torch.serve.lookup.executor import (AsyncContext,
                                                   ExecutableCache,
                                                   GraphExecutable)

    keys, gen, delta = _graph_cell(card, index)
    fn, bind, instr = _graph_fn(gen, delta, kind)
    d = ShardedDispatcher(device=card)
    cache = ExecutableCache()
    ctx = AsyncContext(key=(gen.version,), read_fn=fn,
                       scan_fn=lambda m: fn, bind=bind,
                       instrumented=instr)
    cell = "read" if kind in ("plain", "instrumented", "merged",
                              "merged_instrumented") else "scan"
    kernel = plan.FUSED_KERNELS[index]
    stream = torch.cuda.Stream(card)
    rng = np.random.default_rng(11)
    for bucket in (128, 256, 512, 1024, 2048, 4096):
        exe = cache.get(ctx, cell, 16 if cell == "scan" else 0, bucket,
                        lambda: fn, d.device, warm=True)
        assert isinstance(exe, GraphExecutable)
        assert exe.captured == {"rmi_lookup": int(kernel == "rmi_lookup"),
                                "rmi_bounds": 0, "bounded_search": 0,
                                "pgm_lookup": int(kernel == "pgm_lookup")}
        m = int(rng.integers(bucket // 2 + 1, bucket + 1))
        q = sosd.make_queries(keys, m, seed=bucket)
        args = ((m,) if instr else ()) + bind
        got = d.complete(d.launch((exe,), q, (bind,), ({},),
                                  instrumented=instr,
                                  streams={d.device: stream}))
        (qt,), p = d.pad_and_place(q)
        assert p == bucket
        want = d.finalize(fn(qt, *args), m, instrumented=instr)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if isinstance(g, tuple):
                for gg, ww in zip(g, w):
                    np.testing.assert_array_equal(gg, ww)
            else:
                np.testing.assert_array_equal(g, w)
    stats = cache.graph_stats()
    assert stats["graphs_built"] == 6 and stats["graph_replays"] == 6
    assert stats["kernel_launches"][kernel] == 12   # 6 checks + 6 serving


def test_graph_outputs_survive_the_next_replay_of_the_same_graph(card):
    """24 batches of one bucket through the async executor's ONE graph
    (slots=2), each launched behind ~0.5 ms of device sleep on the
    executor's stream, while the completion thread is held back 10 ms a
    slot, so the launches run a full ring ahead of the completions: each
    batch answers for its own keys.  Each launch copies the graph's
    static outputs into its slot's pinned host buffers right after its
    replay, and slots + 2 buffer sets go round; a read of the static
    outputs at completion, or a set reused one launch early, would hand a
    batch the answers of a later one."""
    from repro_torch.serve.lookup import (LookupService, LookupServiceConfig,
                                          default_spec)

    keys = sosd.generate("osm", 300_000, seed=1)
    svc = LookupService(keys, LookupServiceConfig(
        spec=default_spec("rmi", backend="cuda"), executor="async",
        slots=2, max_batch=4096, warm_buckets=(4096,)), device=card)
    ex, d = svc._async, svc.dispatcher
    launch, complete = d.launch, d.complete

    def launch_behind_sleep(*args, **kwargs):
        with torch.cuda.stream(ex.stream):
            torch.cuda._sleep(1_000_000)
        return launch(*args, **kwargs)

    def complete_late(launched):
        time.sleep(0.01)
        return complete(launched)

    d.launch, d.complete = launch_behind_sleep, complete_late
    qs = [sosd.make_queries(keys, 4096 - 7 * i, seed=i) for i in range(24)]
    with svc:
        futs = [svc.submit(q) for q in qs]
        got = [f.result(60) for f in futs]
    for q, g in zip(qs, got):
        np.testing.assert_array_equal(g, np.searchsorted(keys, q))
    snap = svc.metrics.snapshot()
    assert snap["max_inflight_slots"] >= 2
    stats = svc.exec_cache.graph_stats()
    assert stats["graphs_built"] == 1 and stats["graph_replays"] == 24


def _scribble(card):
    """Allocate and write device memory of every power-of-two size from
    512 B to 64 MiB, four of each, on the current stream: any freed block
    of the caching allocator that fits goes back into use and is
    overwritten.  Keep the result until the check is done."""
    return [torch.full(((512 << k) // 8,), -1, dtype=torch.int64,
                       device=card)
            for k in range(18) for _ in range(4)]


def test_a_stalled_batch_keeps_its_swapped_out_generation(card):
    """A batch launched on generation v1 behind ~0.5 s of device sleep,
    v2 published meanwhile with no other reference to v1 left, then a
    garbage collection and device memory allocated and written: v1's
    keys stay alive until the batch completes (its slot holds the graph,
    the graph holds the plan), and the batch answers from v1."""
    from repro_torch.serve.lookup import (LookupService, LookupServiceConfig,
                                          default_spec)

    keys = sosd.generate("osm", 300_000, seed=1)
    other = sosd.generate("wiki", 300_000, seed=2)
    sp = default_spec("rmi", backend="cuda")
    svc = LookupService(keys, LookupServiceConfig(
        spec=sp, executor="async", warm_buckets=(4096,)), device=card)
    v2 = svc.registry.make_generation(spec.build(sp, other, device=card),
                                      encode_keys(other, card),
                                      backend="cuda", spec=sp)
    svc.warm_now()
    v1_data = weakref.ref(svc.generation.data)
    ex = svc._async
    q = sosd.make_queries(keys, 4000, seed=5)
    with torch.cuda.stream(ex.stream):
        torch.cuda._sleep(1_000_000_000)
    fut = svc.submit(q)
    ex._drain_launches()                 # launched, not completed
    svc.registry.publish_prebuilt(v2)
    del v2
    gc.collect()
    assert v1_data() is not None
    junk = _scribble(card)
    ex._complete_ring_inline()
    np.testing.assert_array_equal(fut.result(0), np.searchsorted(keys, q))
    assert svc.lookup(q[:100]).tolist() == \
        np.searchsorted(other, q[:100]).tolist()
    del junk


def test_a_stalled_merged_batch_keeps_its_delta(card):
    """A merged read launched with delta d1 behind ~0.5 s of device
    sleep, an insert that replaces d1, and a second merged read through
    the same graph with the new delta, then a garbage collection and
    device memory allocated and written: d1 stays alive until the first
    batch completes (its slot holds its context), and each batch answers
    from its own delta."""
    from repro_torch.serve.lookup import (MutableLookupService,
                                          MutableLookupServiceConfig)

    keys = sosd.generate("amzn", 300_000, seed=4)
    rng = np.random.default_rng(9)
    fresh = np.setdiff1d(np.unique(rng.integers(
        int(keys[0]), int(keys[-1]), 1_200, dtype=np.uint64)), keys)
    first, second = fresh[:900], fresh[900:1_000]
    svc = MutableLookupService(keys, MutableLookupServiceConfig(
        index="rmi", backend="cuda", executor="async",
        warm_buckets=(4096,), compact_threshold=100_000), device=card)
    svc.mindex.insert(first)
    svc.warm_now()
    d1 = weakref.ref(svc.mindex.view().delta.device)
    ex = svc._async
    q = sosd.make_queries(np.union1d(keys, fresh), 4000, seed=6)
    with torch.cuda.stream(ex.stream):
        torch.cuda._sleep(1_000_000_000)
    fut1 = svc.submit(q)
    ex._drain_launches()
    svc.mindex.insert(second)            # the view drops d1
    fut2 = svc.submit(q)
    ex._drain_launches()
    gc.collect()
    assert d1() is not None
    junk = _scribble(card)
    ex._complete_ring_inline()
    np.testing.assert_array_equal(
        fut1.result(0), np.searchsorted(np.union1d(keys, first), q))
    np.testing.assert_array_equal(
        fut2.result(0),
        np.searchsorted(np.union1d(keys, np.union1d(first, second)), q))
    assert svc.exec_cache.graph_stats()["graph_replays"] == 2
    del junk


def test_capture_after_publish_while_the_dispatch_thread_serves(card):
    """An async service serves 4 reader threads while a hot swap publishes
    and the warm thread captures the new generation's graphs beside the
    dispatch thread (thread-local capture): every answer matches the key
    set of a generation current between its submit and its result, and
    after the re-warm no batch misses the cache."""
    from repro_torch.serve.lookup import (LookupService, LookupServiceConfig,
                                          default_spec)

    keys = sosd.generate("wiki", 300_000, seed=2)
    union = np.union1d(keys, keys[:-1] + 1)
    q = sosd.make_queries(keys, 64 * 4 * 300, seed=3).reshape(4, 300, 64)
    svc = LookupService(keys, LookupServiceConfig(
        spec=default_spec("pgm", backend="cuda"), executor="async",
        warm_scan_lengths=(16,)), device=card)
    v0 = svc.generation.version
    sets = {v0: keys, v0 + 1: union}
    errors, wrong = [], []

    def reader(c):
        try:
            for i in range(300):
                va = svc.generation.version
                res = svc.submit(q[c, i]).result(120)
                vb = svc.generation.version
                if not any(np.array_equal(res, np.searchsorted(sets[v],
                                                               q[c, i]))
                           for v in range(va, vb + 1)):
                    wrong.append((c, i))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    with svc:
        ts = [threading.Thread(target=reader, args=(c,)) for c in range(4)]
        for t in ts:
            t.start()
        time.sleep(0.05)
        svc.swap_keys(union)
        svc.warm_wait()
        hits, misses = svc.exec_cache.counters()
        for t in ts:
            t.join(300)
        tail = svc.submit(q[0, 0]).result(60)
        hits2, misses2 = svc.exec_cache.counters()
    assert not errors and not wrong
    assert misses2 == misses and hits2 > hits
    np.testing.assert_array_equal(tail, np.searchsorted(union, q[0, 0]))
    with svc.exec_cache._mu:
        assert all(k[0][0] == v0 + 1 for k in svc.exec_cache._exes)


@pytest.mark.parametrize("executor", ["sync", "async"])
def test_mutable_service_across_a_compaction_on_the_card(card, executor):
    """A mixed read/insert/scan trace through the mutable service on the
    card, compactions forced mid-trace and by the threshold: positions,
    admitted flags and scan windows equal the oracle replay's."""
    from repro_torch.serve.lookup import (MutableLookupService,
                                          MutableLookupServiceConfig)
    from repro_torch.workloads import (make_workload, oracle_scan_replay,
                                       replay_on_service)

    keys = sosd.generate("amzn", 200_000, seed=4)
    wl = make_workload(keys, 3_000,
                       mix={"read": 0.5, "insert": 0.3, "range": 0.2},
                       seed=5, range_len=16)
    want, want_win = oracle_scan_replay(keys, wl)
    svc = MutableLookupService(keys, MutableLookupServiceConfig(
        index="pgm", hyper={"eps": 64}, backend="cuda", executor=executor,
        max_batch=512, compact_threshold=300, warm_scan_lengths=(16,)),
        device=card)
    with svc:
        got, got_win = replay_on_service(wl, svc, chunk=48,
                                         compact_every=1_000,
                                         scan_ranges=True)
    np.testing.assert_array_equal(got, want)
    assert set(got_win) == set(want_win)
    for i in want_win:
        np.testing.assert_array_equal(got_win[i], want_win[i])
    assert svc.metrics.snapshot()["compactions"] >= 1
    assert svc.last_compaction_error is None


@pytest.mark.parametrize("index", ["rmi", "pgm"])
@pytest.mark.parametrize("executor", ["sync", "async"])
def test_routed_equals_broadcast_on_the_card(card, executor, index):
    """Routed over 4 shards on the card (every lane on it): reads and
    scans equal broadcast and `np.searchsorted`; each dispatch launches
    the path's kernel once per lane it touched (sync) or replays one
    graph per touched lane (async)."""
    from repro_torch.serve.lookup import (LookupService, LookupServiceConfig,
                                          default_spec)

    keys = sosd.generate("amzn", 400_000, seed=3)
    q = sosd.make_queries(keys, 20_000, seed=4)
    kw = dict(spec=default_spec(index, backend="cuda"), max_batch=2048,
              executor=executor, warm_scan_lengths=(16,))
    bcast = LookupService(keys, LookupServiceConfig(**kw), device=card)
    routed = LookupService(keys, LookupServiceConfig(shards=4, **kw),
                           device=card)
    results = {}
    for svc in (bcast, routed):
        with svc:
            before = _counts()
            futs = [svc.submit(q[i:i + 500]) for i in range(0, 10_000, 500)]
            futs += [svc.scan(q[i:i + 100], 16)
                     for i in range(10_000, 12_000, 100)]
            results[svc] = [f.result(60) for f in futs]
            launched = [a - b for a, b in zip(_counts(), before)]
    for a, b in zip(results[routed], results[bcast]):
        if isinstance(a, tuple):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
        else:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(results[routed][:20]),
                                  np.searchsorted(keys, q[:10_000]))
    touched = sum(r["batches"] for r in routed.metrics.per_shard())
    assert touched > routed.metrics.snapshot()["batches"]
    if executor == "sync":
        kernel = 0 if index == "rmi" else 3
        assert launched == [touched if i == kernel else 0 for i in range(4)]
    else:
        assert launched == [0, 0, 0, 0]       # every graph was warm
        assert routed.exec_cache.graph_stats()["graph_replays"] == touched
        assert routed.metrics.snapshot()["cache_misses"] == 0


def test_a_stalled_routed_batch_keeps_every_lane_and_the_scan_head(card):
    """A routed read and a scan whose windows cross the shard boundary,
    launched on routed generation v1 behind ~0.5 s of device sleep; a
    routed v2 over other keys published meanwhile, no other reference to
    v1 left, then a garbage collection and device memory allocated and
    written: every shard of v1 (and with shard 1 the head shard 0's
    scans merge) stays alive until the slots complete, and both batches
    answer from v1."""
    from repro_torch.serve.lookup import (LookupService, LookupServiceConfig,
                                          ShardTopology, default_spec)

    keys = sosd.generate("osm", 300_000, seed=1)
    other = sosd.generate("wiki", 300_000, seed=2)
    sp = default_spec("rmi", backend="cuda")
    svc = LookupService(keys, LookupServiceConfig(
        spec=sp, executor="async", shards=2, warm_buckets=(128, 2048),
        warm_scan_lengths=(16,)), device=card)
    topo2 = ShardTopology.from_keys(other, 2)
    v2 = [svc.registry.make_generation(
        spec.build(sp, other[a:b], device=card),
        encode_keys(other[a:b], card), backend="cuda", spec=sp, shard=s)
        for s, (a, b) in enumerate(zip(topo2.offsets, topo2.offsets[1:]))]
    svc.warm_now()
    topo = svc.generation.topology
    shard_data = [weakref.ref(g.data) for g in svc.generation.shards]
    ex = svc._async
    q = sosd.make_queries(keys, 3000, seed=5)
    edge = topo.offsets[1]
    anchors = keys[edge - 40:edge + 40:2]
    with torch.cuda.stream(ex.stream):
        torch.cuda._sleep(1_000_000_000)
    fut = svc.submit(q)
    fscan = svc.scan(anchors, 16)
    ex._drain_launches()                 # launched, not completed
    svc.registry.publish_routed(v2, topo2, spec=sp, backend="cuda")
    del v2
    gc.collect()
    assert all(r() is not None for r in shard_data)
    junk = _scribble(card)
    ex._complete_ring_inline()
    np.testing.assert_array_equal(fut.result(0), np.searchsorted(keys, q))
    pos, win = fscan.result(0)
    lb = np.searchsorted(keys, anchors)
    np.testing.assert_array_equal(pos, lb)
    np.testing.assert_array_equal(win, keys[lb[:, None] + np.arange(16)])
    assert svc.lookup(q[:100]).tolist() == \
        np.searchsorted(other, q[:100]).tolist()
    del junk


def test_a_full_routed_ring_stays_exact_with_a_host_set_per_lane(card,
                                                                monkeypatch):
    """24 routed batches of one size over 4 shards (slots=2), each
    launched behind ~0.5 ms of device sleep while completion is held
    back 10 ms a slot, so launches run a full ring ahead: every lane of
    a batch copies into a pinned host set of its own, none reused before
    its slot completes, and each batch answers for its own keys."""
    from repro_torch.serve.lookup import (LookupService, LookupServiceConfig,
                                          default_spec)
    from repro_torch.serve.lookup import dispatch

    keys = sosd.generate("osm", 300_000, seed=1)
    svc = LookupService(keys, LookupServiceConfig(
        spec=default_spec("rmi", backend="cuda"), executor="async",
        slots=2, max_batch=4096, shards=4, warm_buckets=(1024, 2048)),
        device=card)
    ex = svc._async
    launch = svc.dispatcher.launch
    finalize = dispatch._RoutedHandle.finalize

    def launch_behind_sleep(*args, **kwargs):
        with torch.cuda.stream(ex.stream):
            torch.cuda._sleep(1_000_000)
        return launch(*args, **kwargs)

    def finalize_late(handle):
        time.sleep(0.01)
        return finalize(handle)

    svc.dispatcher.launch = launch_behind_sleep
    monkeypatch.setattr(dispatch._RoutedHandle, "finalize", finalize_late)
    qs = [sosd.make_queries(keys, 4096 - 7 * i, seed=i) for i in range(24)]
    with svc:
        futs = [svc.submit(q) for q in qs]
        got = [f.result(60) for f in futs]
    for q, g in zip(qs, got):
        np.testing.assert_array_equal(g, np.searchsorted(keys, q))
    snap = svc.metrics.snapshot()
    assert snap["max_inflight_slots"] >= 2
    touched = sum(r["batches"] for r in svc.metrics.per_shard())
    assert touched == 24 * 4
    assert svc.exec_cache.graph_stats()["graph_replays"] == touched
    # sets in use at once: a full ring, one completing, one launching
    assert 4 <= len(ex._free_hosts) <= (2 + 2) * 4


# ---------------------------------------------------------------------------
# token serving: B1 on int32 keys, the slot index, the engine
# ---------------------------------------------------------------------------
def _int32_widths():
    pow2 = [2 ** k + d for k in range(1, 17) for d in (-1, 0, 1)]
    return sorted({w for w in list(range(1, 65)) + pow2 if 1 <= w <= 2 ** 16})


@pytest.mark.parametrize("layout", ["random", "near_2_31", "empty_windows"])
def test_bounded_search_int32_vs_plain(card, layout):
    """Every width up to 2^16 on each layout; ``empty_windows`` gives each
    query a ``hi`` below its ``lo``, so the kernel returns the clipped
    start."""
    rng = np.random.default_rng(17)
    if layout == "near_2_31":
        keys = np.sort(rng.choice(2 ** 24, 70_000, replace=False)
                       + (2 ** 31 - 2 ** 24)).astype(np.int32)
        keys[-1] = 2 ** 31 - 1
    else:
        keys = np.sort(rng.integers(-2 ** 20, 2 ** 24, 70_000)).astype(np.int32)
    m = 50_000
    q = np.concatenate([keys[rng.integers(0, len(keys), m // 2)],
                        rng.integers(int(keys[0]) - 5, 2 ** 31 - 1, m - m // 2,
                                     dtype=np.int64)]).astype(np.int32)
    lb = np.searchsorted(keys, q)
    d, qt = torch.from_numpy(keys).to(card), torch.from_numpy(q).to(card)
    for width in _int32_widths():
        hi = None
        lo = np.maximum(lb - rng.integers(0, width, m), 0)
        if layout == "empty_windows":
            lo = rng.integers(-3, len(keys), m)
            hi = torch.from_numpy((lo - rng.integers(1, 4, m)).astype(
                np.int32)).to(card)
        lo_t = torch.from_numpy(lo.astype(np.int32)).to(card)
        before = bs_kernel.launch.launches
        got = lower_bound_windows(d, qt, lo_t, width, hi)
        torch.cuda.synchronize()
        assert bs_kernel.launch.launches == before + 1
        assert torch.equal(got, lower_bound_windows_plain(d, qt, lo_t, width,
                                                          hi)), width
        want = (np.clip(lo, 0, len(keys) - 1) if hi is not None else lb)
        np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("layout", ["vllm_256", "one_long", "equal"])
def test_learned_slot_index_on_the_card(card, layout):
    from repro_torch.serve.kv_cache import LearnedSlotIndex

    rng = np.random.default_rng(5)
    lens = {"vllm_256": lambda: rng.integers(1, 8193, 256),
            "one_long": lambda: np.r_[60_000, rng.integers(1, 40, 2999)],
            "equal": lambda: np.full(64, 16)}[layout]()
    cum = np.concatenate([[0], np.cumsum(lens)])
    idx = LearnedSlotIndex(cum)
    slots = np.arange(int(cum[-1]), dtype=np.int32)
    before = bs_kernel.launch.launches
    got = idx.lookup(torch.from_numpy(slots).to(card))
    torch.cuda.synchronize()
    assert bs_kernel.launch.launches == before + 1
    plain = idx.lookup(torch.from_numpy(slots))
    np.testing.assert_array_equal(got.cpu().numpy(), plain.numpy())
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.searchsorted(cum, slots, "right") - 1)


def test_smoke_engine_on_the_card_emits_the_cpu_tokens(card):
    """float32 with TF32 off (the card's default for float32 products,
    set here explicitly): greedy tokens must be the CPU's."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(get_smoke("granite-3-2b"), dtype="float32")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = M.init_params(cfg, seed=0, device="cpu")
        gpu = M.init_params(cfg, seed=0, device="cpu").to(card)
        outs = []
        for params, dev in ((cpu, "cpu"), (gpu, card)):
            eng = ServeEngine(cfg, params, max_batch=4, max_seq=96,
                              page_size=8, device=dev)
            rng = np.random.default_rng(0)
            for _ in range(6):
                eng.submit(list(rng.integers(2, cfg.vocab,
                                             rng.integers(3, 9))), max_new=6)
            outs.append(eng.run(max_steps=64))
            assert eng.cache["blocks"]["sub0"]["k"].device.type == \
                torch.device(dev).type
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert outs[0] == outs[1] and len(outs[0]) == 6


def _smoke_f32(arch):
    import dataclasses

    from repro_torch.configs import get_smoke
    return dataclasses.replace(get_smoke(arch), dtype="float32")


def _serve_smoke(cfg, params, dev, prompts, one_at_a_time=False, **kw):
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, params, device=dev, **kw)
    if not one_at_a_time:
        rids = [eng.submit(p, max_new=6) for p in prompts]
        out = eng.run(max_steps=64)
        return [out[r] for r in rids]
    outs = []
    for p in prompts:
        r = eng.submit(p, max_new=6)
        outs.append(eng.run(max_steps=64)[r])
    return outs


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b", "mixtral-8x22b",
                                  "whisper-tiny"])
def test_smoke_engines_of_the_other_families_emit_the_cpu_tokens(card, arch):
    """The moe, ssm, hybrid and encdec engines in float32 with TF32 off:
    greedy tokens on the card equal the CPU's, and the slot index runs
    B1."""
    from repro_torch.models import model as M

    cfg = _smoke_f32(arch)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(2, cfg.vocab, rng.integers(3, 9)))
               for _ in range(6)]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = M.init_params(cfg, seed=0, device="cpu")
        gpu = M.init_params(cfg, seed=0, device="cpu").to(card)
        kw = dict(max_batch=4, max_seq=96, page_size=8)
        want = _serve_smoke(cfg, cpu, "cpu", prompts, **kw)
        got = _serve_smoke(cfg, gpu, card, prompts, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert got == want
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, gpu, device=card, **kw)
    for _ in range(3):
        eng.submit([2, 3, 4, 5], max_new=8)
    eng.step()
    idx = eng.kv.slot_index()
    slots = np.arange(int(idx.cum[-1]), dtype=np.int32)
    before = bs_kernel.launch.launches
    got = idx.lookup(torch.from_numpy(slots).to(card))
    torch.cuda.synchronize()
    assert bs_kernel.launch.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.searchsorted(idx.cum, slots, "right") - 1)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_recurrent_state_stays_in_its_slot_on_the_card(card, arch):
    """Three requests over 2 slots, batched, equal the same requests served
    one at a time through an engine of the same shape: no slot's SSD state
    moves on another's step or outlives its request."""
    from repro_torch.models import model as M

    cfg = _smoke_f32(arch)
    prompts = [[5, 6, 7, 8], [9, 10, 11], [12, 13, 14, 15, 16]]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        params = M.init_params(cfg, seed=0, device=card)
        kw = dict(max_batch=2, max_seq=64, page_size=8)
        batched = _serve_smoke(cfg, params, card, prompts, **kw)
        alone = _serve_smoke(cfg, params, card, prompts, one_at_a_time=True,
                             **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert batched == alone


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------
def _train_batch(cfg, dev, seed=0, b=4, s=32):
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-moe-16b",
                                  "mamba2-2.7b", "whisper-tiny"])
def test_smoke_train_step_on_the_card_equals_the_cpu(card, arch):
    """Two float32 steps (TF32 off) from the same weights: loss, grad norm
    and lr within 1e-5 relative; the first gradient within ``1e-5 G +
    1e-4 |g|`` (G the largest gradient element); every parameter within
    twice the summed learning rates (AdamW normalizes a gradient at
    rounding-noise level, such as a key bias's, to a step anywhere in
    [-1, 1]: `chip_smoke.py`'s train_check tolerance)."""
    import dataclasses

    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import AdamW, cosine_schedule

    cfg = _smoke_f32(arch)
    if cfg.n_experts:            # dropless: a tie cannot flip a drop
        cfg = dataclasses.replace(
            cfg, capacity_factor=1.001 * cfg.n_experts / cfg.top_k)
    opt = AdamW(lr=cosine_schedule(3e-3, warmup=1, total=4))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = []
        for dev in ("cpu", card):
            model = M.init_params(cfg, seed=0, device="cpu").to(dev)
            grads = [g.cpu() for g in torch.autograd.grad(
                M.loss_fn(cfg, model, _train_batch(cfg, dev)),
                list(model.parameters()))]
            state = TS.TrainState(model, opt.init(model))
            step = TS.make_train_step(cfg, opt)
            metrics = []
            for s in range(2):
                state, m = step(state, _train_batch(cfg, dev, seed=s))
                metrics.append({k: float(v) for k, v in m.items()})
            runs.append((metrics, [p.detach().cpu()
                                   for p in model.parameters()], grads))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    (want, pw, gw), (got, pg, gg) = runs
    for a, b in zip(got, want):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    big = max(float(g.abs().max()) for g in gw)
    for a, b in zip(gg, gw):
        assert float(((a - b).abs() - 1e-4 * b.abs()).max()) <= 1e-5 * big
    lr_sum = sum(m["lr"] for m in want)
    for a, b in zip(pg, pw):
        assert float((a - b).abs().max()) <= 2 * lr_sum


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_of_card_tensors(card, dtype, tmp_path):
    """A stepped state on the card, saved on a thread and restored into
    one drawn from another seed: every tensor equal and on the card."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import AdamW, cosine_schedule

    cfg = dataclasses.replace(get_smoke("granite-3-2b"), dtype=dtype)
    opt = AdamW(lr=cosine_schedule(3e-3, warmup=1, total=4))

    def state_of(seed):
        model = M.init_params(cfg, seed=seed, device=card)
        return TS.TrainState(model, opt.init(model))

    state, _ = TS.make_train_step(cfg, opt)(state_of(0),
                                            _train_batch(cfg, card))
    want = [t.detach().clone() for _, t in CK._flatten(state)]
    th = CK.save(str(tmp_path), 1, state)
    th.join(timeout=120)
    assert not th.is_alive()
    got = CK.restore(str(tmp_path), 1, state_of(1))
    for (_, a), b in zip(CK._flatten(got), want):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_moe_functions_on_the_card(card):
    """Each gather-only Function's forward and backward on the card equal
    the CPU's (gathers exact, sums over k within 1e-6), and gradcheck
    holds in float64."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models import moe as MOE

    cfg = dataclasses.replace(get_smoke("deepseek-moe-16b"), n_experts=4,
                              top_k=2, capacity_factor=0.5)
    rng = np.random.default_rng(0)
    top_i = torch.from_numpy(np.stack(
        [rng.choice(4, 2, replace=False, p=[0.55, 0.15, 0.15, 0.15])
         for _ in range(24)]))
    k, e = cfg.top_k, cfg.n_experts
    plans = {d: MOE.sorted_dispatch_plan(cfg, top_i.to(d))
             for d in ("cpu", card)}
    cap, j = plans["cpu"]["cap"], plans["cpu"]["order"].shape[1]
    assert not bool(plans["cpu"]["keep"].all())

    def fns(plan):
        slots = [plan[n] for n in ("inv_slot", "flat_slot", "keep")]
        perm = [plan["tok_sorted"], plan["inv_perm"]]
        return [
            (lambda a: MOE.SortedToSlots.apply(MOE._pad_row(a), *slots),
             (1, j, 5), False),
            (lambda a: MOE.SlotsToSorted.apply(a, *slots), (1, e * cap, 5),
             False),
            (lambda a: MOE.TokensToSorted.apply(k, a, *perm), (1, j // k, 5),
             True),
            (lambda a: MOE.SortedToTokens.apply(k, a, *perm), (1, j, 5),
             True)]

    for n, ((fc, shape, sums), (fg, _, _)) in enumerate(
            zip(fns(plans["cpu"]), fns(plans[card]))):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        outs = []
        for f, dev in ((fc, "cpu"), (fg, card)):
            xt = x.to(dev).requires_grad_()
            y = f(xt)
            ct = torch.ones_like(y) + torch.arange(
                y.numel(), device=dev).reshape(y.shape) % 7
            (dx,) = torch.autograd.grad(y, xt, ct)
            outs.append((y.detach().cpu(), dx.cpu()))
        (yc, dc), (yg, dg) = outs
        if sums:
            torch.testing.assert_close(yg, yc, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(dg, dc, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(yg, yc) and torch.equal(dg, dc), n
        x64 = x.double().to(card).requires_grad_()
        assert torch.autograd.gradcheck(fg, (x64,)), n


# ---------------------------------------------------------------------------
# the distributed layer on the card (NCCL)
# ---------------------------------------------------------------------------
def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def nccl1(card):
    """A one-rank NCCL group at an explicit ``tcp://127.0.0.1`` address,
    and its (1, 1) ("data", "model") mesh."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            device_id=torch.device("cuda", 0))
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


def test_nccl_at_one_rank_and_its_mesh(nccl1):
    import torch.distributed as dist
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    assert nccl1.device_type == "cuda"
    assert nccl1.mesh_dim_names == ("data", "model")
    x = torch.arange(6.0, device="cuda")
    dist.all_reduce(x)
    assert torch.equal(x, torch.arange(6.0, device="cuda"))


def test_compressed_all_reduce_on_the_card_equals_its_plain_sum(nccl1):
    from repro_torch.dist import compression as C
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1 << 20, generator=g, device="cuda")
    err = torch.randn(1 << 20, generator=g, device="cuda") * 1e-3
    total, residual = C.compressed_all_reduce(x, None, err)
    c, want = C.quantize(x.cpu(), err.cpu())
    assert torch.equal(total.cpu(), C.dequantize(c))
    assert torch.equal(residual.cpu(), want)


def test_pipeline_at_one_stage_on_the_card_equals_sequential(nccl1):
    from repro_torch.dist.pipeline_parallel import (pipeline_apply,
                                                    sequential_apply)
    g = torch.Generator(device="cuda").manual_seed(1)
    ws = torch.randn(4, 64, 64, generator=g, device="cuda") * 0.1
    x = torch.randn(6, 8, 64, generator=g, device="cuda")

    def body(a, w):
        return torch.tanh(a @ w)

    assert torch.equal(pipeline_apply(body, ws, x, nccl1),
                       sequential_apply(body, ws, x))


def test_data_parallel_step_on_the_card_equals_the_one_rank_step(nccl1):
    """One NCCL rank repeats the one-device step bit for bit (float32,
    three steps)."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import AdamW, cosine_schedule

    cfg = dataclasses.replace(get_smoke("granite-3-2b"), dtype="float32")
    opt = AdamW(lr=cosine_schedule(3e-3, warmup=10, total=3))
    one = M.init_params(cfg, seed=0, device="cuda")
    state = TS.TrainState(one, opt.init(one))
    dp = TS.DataParallel(cfg, opt, nccl1)
    dstate = dp.init(M.init_params(cfg, seed=0, device="cuda"))
    step = TS.make_train_step(cfg, opt)
    for s in range(3):
        batch = _train_batch(cfg, "cuda", seed=s)
        state, m = step(state, batch)
        dstate, dm = dp.step(dstate, batch)
        assert {k: float(v) for k, v in m.items()} == {
            k: float(v) for k, v in dm.items()}
    for p, q in zip(state.params.parameters(), dstate.params.parameters()):
        assert torch.equal(p, q)


def test_data_parallel_step_under_remat_dots_on_the_device_thread(
        nccl1, monkeypatch):
    """One NCCL rank under remat "dots": autograd recomputes each unit on
    its device thread, under the step's context (its parameter store
    included), and the step equals the one-device step bit for bit
    (float32, three steps)."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.dist import sharding as SH
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import AdamW, cosine_schedule

    installed = []
    in_context = SH.in_context

    def recorded(saved):
        installed.append((threading.get_ident(), saved[-1]))
        return in_context(saved)

    monkeypatch.setattr(SH, "in_context", recorded)
    cfg = dataclasses.replace(get_smoke("granite-3-2b"), dtype="float32",
                              remat="dots")
    opt = AdamW(lr=cosine_schedule(3e-3, warmup=10, total=3))
    one = M.init_params(cfg, seed=0, device="cuda")
    state = TS.TrainState(one, opt.init(one))
    dp = TS.DataParallel(cfg, opt, nccl1)
    dstate = dp.init(M.init_params(cfg, seed=0, device="cuda"))
    step = TS.make_train_step(cfg, opt)
    for s in range(3):
        batch = _train_batch(cfg, "cuda", seed=s)
        state, m = step(state, batch)
        dstate, dm = dp.step(dstate, batch)
        assert {k: float(v) for k, v in m.items()} == {
            k: float(v) for k, v in dm.items()}
    for p, q in zip(state.params.parameters(), dstate.params.parameters()):
        assert torch.equal(p, q)
    main = threading.get_ident()
    assert any(t != main and store is dp for t, store in installed)


@pytest.fixture
def two_cards(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards")
    return card


def test_driver_on_two_cards_equals_one(two_cards, tmp_path):
    """The train driver at smoke width on 2 NCCL ranks against 1: every
    loss and grad norm within 2e-3 relative (bf16 products over another
    batch split round otherwise), a limit that one rank on half the batch
    (what a rank computes that reduces nothing) must fall outside.  Each
    card of the two peaks below the one rank's peak by at least what the
    dry run reckons the two store less (parameters and both float32
    moments), less 10%."""
    import json
    import os
    import subprocess
    import sys

    from repro_torch.configs import get_smoke
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.dryrun import MeshShape, device_bytes
    from repro_torch.models import model as M

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))

    def run(world, batch):
        out = tmp_path / f"m{world}_{batch}.json"
        # a file store: a TCP port picked free may be taken again before
        # rank 0 listens on it
        url = f"file://{tmp_path / f'store{world}_{batch}'}"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
             "--steps", "3", "--global-batch", str(batch), "--dist-init",
             url, "--rank", str(r), "--world-size", str(world),
             "--metrics-out", str(out)],
            env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(world)]
        try:
            for p in procs:
                _, err = p.communicate(timeout=300)
                assert p.returncode == 0, err[-2000:]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        return json.loads(out.read_text())

    def rel(got, want):
        return max(abs(a - b) / abs(b) for k in ("loss", "grad_norm")
                   for a, b in zip(got[k], want[k]))

    def stored(world):
        cfg = get_smoke("granite-3-2b")
        named = dict(M.init_params(cfg, device="meta").named_parameters())
        mesh = MeshShape((world, 1), ("data", "model"))
        specs = M.param_specs(cfg)
        f32 = {n: p.float() for n, p in named.items()}
        return (device_bytes(named, specs, mesh, SH.PARAM_RULES)
                + 2 * device_bytes(f32, specs, mesh, SH.PARAM_RULES))

    one, two, half = run(1, 8), run(2, 8), run(1, 4)
    assert rel(two, one) <= 2e-3, (two, one)
    assert rel(half, one) > 2e-3, (half, one)
    drop = stored(1) - stored(2)
    for peak in two["peak_mem_gb"]:
        assert (one["peak_mem_gb"][0] - peak) * 1e9 >= 0.9 * drop, (
            one["peak_mem_gb"], two["peak_mem_gb"], drop)


# ---------------------------------------------------------------------------
# lookup serving over several cards
# ---------------------------------------------------------------------------
def _serve_cards(keys, q, devices, executor="async"):
    """Answers and health record of the RMI service over ``devices``."""
    from repro_torch.serve.lookup import (LookupService, LookupServiceConfig,
                                          default_spec)

    svc = LookupService(keys, LookupServiceConfig(
        spec=default_spec("rmi", backend="cuda"), executor=executor,
        max_batch=1024, warm_buckets=(256, 1024)), devices=devices)
    with svc:
        futs = [svc.submit(q[i:i + 300]) for i in range(0, q.size, 300)]
        got = np.concatenate([f.result(60) for f in futs])
    return svc, got, svc.health.current()


@pytest.mark.parametrize("executor", ["sync", "async"])
def test_broadcast_over_one_card_twice_equals_one_card(card, executor):
    """Two slices of every batch on the one card: exact, and the health
    record of the split run is the one-card record."""
    keys = sosd.generate("osm", 300_000, seed=1)
    q = sosd.make_queries(keys, 6_000, seed=2)
    _, one, r1 = _serve_cards(keys, q, ["cuda:0"], executor)
    svc, two, r2 = _serve_cards(keys, q, ["cuda:0", "cuda:0"], executor)
    assert svc.dispatcher.n_shards == 2
    np.testing.assert_array_equal(one, np.searchsorted(keys, q))
    np.testing.assert_array_equal(two, one)
    for f in ("n", "disp_sum", "disp_max", "width_sum", "steps_sum"):
        assert getattr(r2, f) == getattr(r1, f), f
    np.testing.assert_array_equal(r2.traffic_total, r1.traffic_total)


def test_broadcast_over_two_cards_is_exact(two_cards):
    """Slices on cuda:0 and cuda:1, each over its card's replica: exact,
    every card launches the fused kernel, and card 1's replica answers a
    batch bit for bit as card 0's does."""
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    keys = sosd.generate("osm", 300_000, seed=1)
    q = sosd.make_queries(keys, 6_000, seed=2)
    before = dict(rmi_kernel.launch_lookup.by_device)
    svc, got, _ = _serve_cards(keys, q, [c0, c1])
    np.testing.assert_array_equal(got, np.searchsorted(keys, q))
    by_card = svc.exec_cache.graph_launches_by_device()
    assert by_card["cuda:0"]["rmi_lookup"] > 0
    assert by_card["cuda:1"]["rmi_lookup"] > 0
    assert rmi_kernel.launch_lookup.by_device["cuda:1"] > \
        before.get("cuda:1", 0)
    gen = svc.generation
    g1 = gen.on(c1)
    assert g1.data.device == c1 and g1.version == gen.version
    assert g1.plan._cache["_rmi_f32_state"].a2.device == c1
    a = gen.fn(encode_keys(q, c0)).cpu()
    b = g1.fn(encode_keys(q, c1)).cpu()
    assert torch.equal(a, b)


def test_graph_captured_on_card1_from_a_card0_thread(two_cards):
    """A graph of a plan on cuda:1, captured and replayed from a thread
    whose current device is cuda:0, replays to the eager answers."""
    from repro_torch.serve.lookup.executor import GraphExecutable

    c1 = torch.device("cuda", 1)
    keys = sosd.generate("wiki", 200_000, seed=1)
    b = spec.build(spec.IndexSpec("pgm", {"eps": 64}), keys, device=c1)
    fn = plan.lower(b, encode_keys(keys, c1)).compile("cuda")
    q = encode_keys(sosd.make_queries(keys, 1024, seed=3), c1)
    out = {}

    def run():
        torch.cuda.set_device(0)
        exe = GraphExecutable(fn, 1024, (), False, c1)
        got = exe(q).clone()
        torch.cuda.synchronize(c1)
        out["got"] = got

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert out["got"].device == c1
    assert torch.equal(out["got"], fn(q))


def test_kernel_launch_on_card1_from_card0(two_cards):
    """The kernels launch on cuda:1 while cuda:0 is current, and count
    the launch on cuda:1."""
    c1 = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    keys = sosd.generate("osm", 200_000, seed=5)
    q = sosd.make_queries(keys, 5_000, seed=6)
    d, qt = encode_keys(keys, c1), encode_keys(q, c1)
    lb = np.searchsorted(keys, q)
    n1 = bs_kernel.launch.by_device.get("cuda:1", 0)
    lo = torch.from_numpy(np.maximum(lb - 3, 0)).to(c1)
    got = lower_bound_windows(d, qt, lo, 8)
    assert bs_kernel.launch.by_device["cuda:1"] == n1 + 1
    np.testing.assert_array_equal(got.cpu().numpy(), lb)
    st = ops.prepare_f32_state(keys, branching=4096, device=c1)
    m1 = rmi_kernel.launch_lookup.by_device.get("cuda:1", 0)
    np.testing.assert_array_equal(ops.rmi_lookup(st, d, qt).cpu().numpy(),
                                  lb)
    assert rmi_kernel.launch_lookup.by_device["cuda:1"] == m1 + 1
    p = plan.lower(spec.build(spec.IndexSpec("pgm"), keys, device=c1), d)
    g1 = pgm_kernel.launch_lookup.by_device.get("cuda:1", 0)
    np.testing.assert_array_equal(p.compile("cuda")(qt).cpu().numpy(), lb)
    assert pgm_kernel.launch_lookup.by_device["cuda:1"] == g1 + 1
    assert torch.cuda.current_device() == 0


def test_a_stalled_batch_on_card1_keeps_its_swapped_out_replica(two_cards):
    """`test_a_stalled_batch_keeps_its_swapped_out_generation` over two
    cards: the batch's slice on cuda:1 stalls behind ~0.5 s of device
    sleep on the executor's cuda:1 stream while v2 is published; v1's
    cuda:1 replica stays alive until the batch completes, and the batch
    answers from v1."""
    from repro_torch.serve.lookup import (LookupService, LookupServiceConfig,
                                          default_spec)

    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    keys = sosd.generate("osm", 300_000, seed=1)
    other = sosd.generate("wiki", 300_000, seed=2)
    sp = default_spec("rmi", backend="cuda")
    svc = LookupService(keys, LookupServiceConfig(
        spec=sp, executor="async", warm_buckets=(4096,)), devices=[c0, c1])
    v2 = svc.registry.make_generation(spec.build(sp, other, device=c0),
                                      encode_keys(other, c0),
                                      backend="cuda", spec=sp)
    svc.warm_now()
    v1_data = weakref.ref(svc.generation.on(c1).data)
    ex = svc._async
    q = sosd.make_queries(keys, 4000, seed=5)
    with torch.cuda.stream(ex.streams[c1]):
        torch.cuda._sleep(1_000_000_000)
    fut = svc.submit(q)
    ex._drain_launches()                 # launched, not completed
    svc.registry.publish_prebuilt(v2)
    del v2
    gc.collect()
    assert v1_data() is not None
    with torch.cuda.device(c1):
        junk = _scribble(c1)
    ex._complete_ring_inline()
    np.testing.assert_array_equal(fut.result(0), np.searchsorted(keys, q))
    assert svc.lookup(q[:100]).tolist() == \
        np.searchsorted(other, q[:100]).tolist()
    del junk
