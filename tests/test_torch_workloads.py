"""The port's workload copies against the reference's `repro.workloads`.

Same seed, same stream: every rank sampler, `make_workload` over every
mix and distribution, `make_point_queries`, and the replay oracles equal
the reference's op for op; the on-disk trace round-trips between the two
packages.
"""
import numpy as np
import pytest

from repro import workloads as rwl
from repro.data import sosd as rsosd
from repro_torch import workloads as wl_mod
from repro_torch.workloads import (MIXES, OP_INSERT, OP_RANGE, Workload,
                                   make_workload, oracle_replay,
                                   oracle_scan_replay)

UINT64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.fixture(scope="module")
def keys():
    return rsosd.generate("amzn", 20_000, seed=1)


def _same(a, b):
    np.testing.assert_array_equal(a.ops, b.ops)
    np.testing.assert_array_equal(a.keys, b.keys)
    np.testing.assert_array_equal(a.aux, b.aux)
    assert a.ops.dtype == b.ops.dtype and a.keys.dtype == b.keys.dtype
    assert a.aux.dtype == b.aux.dtype
    assert a.meta == b.meta


def test_constants_and_names_match_reference():
    assert MIXES == rwl.MIXES
    assert (wl_mod.OP_READ, wl_mod.OP_INSERT, wl_mod.OP_RANGE) == \
        (rwl.OP_READ, rwl.OP_INSERT, rwl.OP_RANGE)
    assert wl_mod.OP_NAMES == rwl.OP_NAMES
    assert sorted(wl_mod.DISTRIBUTIONS) == sorted(rwl.DISTRIBUTIONS)
    assert set(wl_mod.__all__) == set(rwl.__all__)


@pytest.mark.parametrize("dist,kw", [
    ("uniform", {}), ("zipfian", {}), ("zipfian", {"theta": 0.7,
                                                   "scramble": False}),
    ("hot_set", {}), ("hot_set", {"hot_frac": 0.1, "hot_weight": 0.5}),
    ("sequential", {}), ("sequential", {"stride": 7}),
])
def test_rank_samplers_match_reference(dist, kw):
    for seed in (0, 3):
        got = wl_mod.DISTRIBUTIONS[dist](np.random.default_rng(seed), 5_000,
                                         12_345, **kw)
        want = rwl.DISTRIBUTIONS[dist](np.random.default_rng(seed), 5_000,
                                       12_345, **kw)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.int64


@pytest.mark.parametrize("mix", sorted(MIXES) + ["custom"])
@pytest.mark.parametrize("dist", ["uniform", "zipfian", "hot_set",
                                  "sequential"])
def test_make_workload_matches_reference_op_for_op(keys, mix, dist):
    m = {"read": 3, "insert": 1, "range": 2} if mix == "custom" else mix
    for seed in (0, 11):
        _same(make_workload(keys, 1_500, mix=m, dist=dist, seed=seed,
                            present_frac=0.8, range_len=24),
              rwl.make_workload(keys, 1_500, mix=m, dist=dist, seed=seed,
                                present_frac=0.8, range_len=24))


def test_make_workload_over_uint64_max_keys_matches_reference():
    ks = np.concatenate([np.arange(10, 2_010, dtype=np.uint64),
                         np.array([UINT64_MAX], np.uint64)])
    _same(make_workload(ks, 400, mix="ycsb_a", dist="uniform", seed=1,
                        present_frac=0.5),
          rwl.make_workload(ks, 400, mix="ycsb_a", dist="uniform", seed=1,
                            present_frac=0.5))
    with pytest.raises(ValueError):
        make_workload(ks, 10, mix={"read": 0.0})
    with pytest.raises(ValueError):
        make_workload(np.array([], np.uint64), 10)


@pytest.mark.parametrize("dist", ["uniform", "zipfian"])
def test_make_point_queries_matches_reference(keys, dist):
    np.testing.assert_array_equal(
        wl_mod.make_point_queries(keys, 3_000, seed=4, dist=dist),
        rwl.make_point_queries(keys, 3_000, seed=4, dist=dist))


def test_trace_round_trips_between_the_packages(tmp_path, keys):
    wl = make_workload(keys, 300, mix="ycsb_e", dist="sequential", seed=9)
    p1, p2 = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    wl.save(p1)
    back = Workload.load(p1)
    _same(wl, back)
    assert back.meta["mix"] == "ycsb_e" and back.meta["seed"] == 9
    _same(wl, rwl.Workload.load(p1))
    rwl.make_workload(keys, 300, mix="ycsb_e", dist="sequential",
                      seed=9).save(p2)
    _same(Workload.load(p2), wl)
    assert wl.counts() == rwl.Workload.load(p2).counts()


@pytest.mark.parametrize("mix", ["ycsb_a", "ycsb_e",
                                 {"read": 0.5, "insert": 0.3, "range": 0.2}])
def test_replay_oracles_match_reference(keys, mix):
    wl = make_workload(keys, 800, mix=mix, dist="zipfian", seed=5,
                       range_len=16)
    rw = rwl.make_workload(keys, 800, mix=mix, dist="zipfian", seed=5,
                           range_len=16)
    np.testing.assert_array_equal(oracle_replay(keys, wl),
                                  rwl.oracle_replay(keys, rw))
    out, win = oracle_scan_replay(keys, wl)
    rout, rwin = rwl.oracle_scan_replay(keys, rw)
    np.testing.assert_array_equal(out, rout)
    assert set(win) == set(rwin) == set(np.flatnonzero(wl.ops == OP_RANGE))
    for i in win:
        np.testing.assert_array_equal(win[i], rwin[i])
        assert win[i].dtype == np.uint64


def test_oracle_replay_read_only_matches_searchsorted(keys):
    wl = make_workload(keys, 400, mix="read_only", dist="hot_set", seed=8)
    np.testing.assert_array_equal(oracle_replay(keys, wl),
                                  np.searchsorted(keys, wl.keys))
    assert not (wl.ops == OP_INSERT).any()
