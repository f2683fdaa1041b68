"""The port's range-routed serving against the reference's.

The cases of `tests/test_serve_topology.py` on the port: the topology's
routing algebra (`route`, `route_device` over encoded keys, duplicate-safe
splits, replica apportionment, `describe`) equal to the reference's
`ShardTopology` on the same keys; and the routed service (CPU, the
``torch`` backend) bit-identical to the port's broadcast service, to
``np.searchsorted`` and to the reference's routed ``jnp`` service on one
device: positions, scan windows, per-shard health vectors, the merged
health snapshot, the global traffic histogram and the per-shard metric
rows, on both executors.
"""
import jax

jax.config.update("jax_enable_x64", True)

import functools

import numpy as np
import pytest
import torch

from repro.core.spec import IndexSpec as RIndexSpec
from repro.data import sosd as rsosd
from repro.dist import sharding as rsharding
from repro.serve.lookup import LookupService as RLookupService
from repro.serve.lookup import LookupServiceConfig as RLookupServiceConfig
from repro.serve.lookup import ShardTopology as RShardTopology
from repro_torch.core import base
from repro_torch.core.spec import IndexSpec, Tuner
from repro_torch.data import sosd
from repro_torch.kernels.common import encode_keys
from repro_torch.obs.export import MetricsServer, metrics_payload
from repro_torch.serve.lookup import (LookupService, LookupServiceConfig,
                                      RoutedDispatcher, RoutedGeneration,
                                      ShardTopology, shard_replica_groups)

CPU = "cpu"
N_KEYS = 60_000
UINT64_MAX = np.uint64(2**64 - 1)


def _oracle(keys, q):
    return base.lower_bound_oracle(keys, q)


@pytest.fixture(scope="module")
def amzn():
    keys = sosd.generate("amzn", N_KEYS, seed=7)
    q = sosd.make_queries(keys, 8_000, seed=11, present_frac=0.6)
    return keys, q


def _svc(keys, **kw):
    cfg = dict(spec=IndexSpec("rmi", {}), max_batch=1024, deadline_ms=0.0)
    cfg.update(kw)
    return LookupService(keys, LookupServiceConfig(**cfg), device=CPU)


# ---------------------------------------------------------------------------
# the topology value object against the reference's
# ---------------------------------------------------------------------------
def _key_sets():
    rng = np.random.default_rng(3)
    vals = np.sort(rng.choice(10_000, size=50, replace=False))
    return {
        "evens": np.arange(0, 1000, 2, dtype=np.uint64),
        "dups": np.sort(np.repeat(vals, 40).astype(np.uint64)),
        "sparse": np.sort(np.random.default_rng(5).choice(
            2**40, size=4096, replace=False).astype(np.uint64)),
        "high": np.sort(np.random.default_rng(6).choice(
            2**20, size=3000, replace=False).astype(np.uint64)
            + np.uint64(2**64 - 2**20)),
        "constant": np.full(5000, 42, dtype=np.uint64),
    }


KEY_SETS = sorted(_key_sets())


@pytest.mark.parametrize("n_shards", [1, 2, 5, 8])
@pytest.mark.parametrize("name", KEY_SETS)
def test_topology_matches_reference(name, n_shards):
    keys = _key_sets()[name]
    topo = ShardTopology.from_keys(keys, n_shards)
    ref = RShardTopology.from_keys(keys, n_shards)
    assert topo.offsets == ref.offsets
    assert topo.replicas == ref.replicas and topo.n_keys == ref.n_keys
    np.testing.assert_array_equal(topo.split_points, ref.split_points)
    assert topo.split_points.dtype == np.uint64
    assert topo.describe() == ref.describe()
    assert topo.min_shard_len == ref.min_shard_len
    # no duplicate run straddles a split
    for s in range(1, topo.n_shards):
        o = topo.offsets[s]
        assert keys[o - 1] != keys[o]
    # routes on split points, their neighbours, the extremes, the keys
    sp = topo.split_points
    q = np.concatenate([sp, sp - np.uint64(1), sp + np.uint64(1), keys,
                        np.array([0, 2**63, 2**64 - 1], dtype=np.uint64)])
    want = ref.route(q)
    np.testing.assert_array_equal(topo.route(q), want)
    dev = topo.route_device(encode_keys(q, CPU))
    assert dev.dtype == torch.int32
    np.testing.assert_array_equal(dev.numpy(), want)
    import jax.numpy as jnp
    np.testing.assert_array_equal(
        np.asarray(ref.route_device(jnp.asarray(q)), dtype=np.int64), want)
    # routed ranks equal the global lower bound, duplicates included
    sid = topo.route(keys)
    pos = np.empty(keys.size, dtype=np.int64)
    for s in range(topo.n_shards):
        m = sid == s
        lo, hi = topo.offsets[s], topo.offsets[s + 1]
        pos[m] = lo + np.searchsorted(keys[lo:hi], keys[m], side="left")
    np.testing.assert_array_equal(pos, _oracle(keys, keys))


def test_route_split_points_side_left():
    keys = np.arange(0, 1000, 2, dtype=np.uint64)
    topo = ShardTopology.from_keys(keys, 4)
    for s, split in enumerate(topo.split_points):
        assert topo.route(np.array([split], dtype=np.uint64))[0] == s
        assert topo.route(np.array([split + 1], dtype=np.uint64))[0] == s + 1
        assert keys[topo.offsets[s + 1] - 1] == split


def test_single_and_collapsed_topologies():
    topo = ShardTopology.single(1000)
    assert topo.n_shards == 1 and topo.describe() == \
        RShardTopology.single(1000).describe()
    q = np.array([0, 7, 2**63, 2**64 - 1], dtype=np.uint64)
    np.testing.assert_array_equal(topo.route(q), np.zeros(4, np.int64))
    np.testing.assert_array_equal(
        topo.route_device(encode_keys(q, CPU)).numpy(), np.zeros(4))
    flat = ShardTopology.from_keys(np.full(5000, 42, np.uint64), 8)
    assert flat.n_shards == 1 and flat.offsets == (0, 5000)


@pytest.mark.parametrize("bad", [dict(n_shards=0), dict(replicas=0),
                                 dict(replicas=[1, 0])])
def test_topology_refusals_match_reference(bad):
    keys = np.arange(100, dtype=np.uint64)
    kw = dict(n_shards=2, replicas=1)
    kw.update(bad)
    with pytest.raises(ValueError) as ref_err:
        RShardTopology.from_keys(keys, kw["n_shards"], kw["replicas"])
    with pytest.raises(ValueError) as err:
        ShardTopology.from_keys(keys, kw["n_shards"], kw["replicas"])
    assert str(err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="zero keys"):
        ShardTopology.from_keys(np.empty(0, np.uint64), 2)


@pytest.mark.parametrize("masses,total", [
    ([97.0, 1.0, 1.0, 1.0], 8), ([1.0, 1.0, 1.0, 1.0], 8),
    ([0.0, 0.0, 0.0, 0.0], 6), ([5.0, 0.0, 3.0, 2.0], 11),
    ([1.0, 2.0, 3.0, 4.0], None)])
def test_replica_apportionment_matches_reference(masses, total):
    keys = np.arange(4000, dtype=np.uint64)
    topo = ShardTopology.from_keys(keys, 4, replicas=2)
    ref = RShardTopology.from_keys(keys, 4, replicas=2)
    got = topo.rebalanced_from_masses(masses, total_replicas=total)
    want = ref.rebalanced_from_masses(masses, total_replicas=total)
    assert got.replicas == want.replicas
    assert sum(got.replicas) == (total if total is not None else 8)
    assert min(got.replicas) >= 1
    assert got.offsets == topo.offsets
    np.testing.assert_array_equal(got.split_points, topo.split_points)


@pytest.mark.parametrize("hot", [None, slice(0, 8), slice(20, 22),
                                 slice(31, 32)])
def test_rebalanced_from_traffic_histogram_matches_reference(hot):
    keys = np.arange(8000, dtype=np.uint64)
    hist = np.ones(32)
    if hot is not None:
        hist = np.zeros(32)
        hist[hot] = 100.0
    got = ShardTopology.from_keys(keys, 4).rebalanced(hist, 8)
    want = RShardTopology.from_keys(keys, 4).rebalanced(hist, 8)
    assert got.replicas == want.replicas
    if hot is None:
        assert got.replicas == (2, 2, 2, 2)


@pytest.mark.parametrize("replicas", [(1, 1, 1), (2, 1, 3), (4,),
                                      (1, 2, 2, 1)])
@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_shard_replica_groups_match_reference(n_dev, replicas):
    devices = [f"cuda:{i}" for i in range(n_dev)]
    assert shard_replica_groups(devices, replicas) == \
        rsharding.shard_replica_groups(devices, replicas)


def test_shard_replica_groups_refusals():
    with pytest.raises(ValueError, match="at least one device"):
        shard_replica_groups([], (1,))
    with pytest.raises(ValueError, match="at least one replica"):
        shard_replica_groups(["cpu"], (1, 0))


# ---------------------------------------------------------------------------
# the routed service: routed == broadcast == oracle == the reference
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _reference_routed(index, executor, shards=4):
    keys = rsosd.generate("amzn", N_KEYS, seed=7)
    q = rsosd.make_queries(keys, 8_000, seed=11, present_frac=0.6)[:2000]
    svc = RLookupService(keys, RLookupServiceConfig(
        spec=RIndexSpec(index, {}), max_batch=1024, deadline_ms=0.0,
        executor=executor, shards=shards))
    try:
        return svc.lookup(q)
    finally:
        svc.stop()


@pytest.mark.parametrize("index", ["rmi", "pgm", "radix_spline"])
@pytest.mark.parametrize("executor", ["sync", "async"])
def test_routed_parity_matrix(amzn, index, executor):
    keys, q = amzn
    q = q[:2000]
    sp = IndexSpec(index, {})
    bcast = _svc(keys, spec=sp, executor=executor)
    routed = _svc(keys, spec=sp, executor=executor, shards=4)
    try:
        got_b = bcast.lookup(q)
        got_r = routed.lookup(q)
        assert isinstance(routed.generation, RoutedGeneration)
        assert isinstance(routed.dispatcher, RoutedDispatcher)
        assert routed.dispatcher.n_shards == 4
        assert got_r.dtype == np.int64
        np.testing.assert_array_equal(got_r, got_b)
        np.testing.assert_array_equal(got_r, _oracle(keys, q))
        np.testing.assert_array_equal(got_r,
                                      _reference_routed(index, executor))
    finally:
        bcast.stop()
        routed.stop()


@pytest.mark.parametrize("executor", ["sync", "async"])
def test_routed_parity_cuda_backend_plain_versions(amzn, executor):
    """The ``cuda`` backend's plain versions behind every lane (the
    fused RMI path and B1 for PGM) on the CPU."""
    keys, q = amzn
    q = q[:1000]
    for sp in (IndexSpec("rmi", {}, backend="cuda"),
               IndexSpec("pgm", {}, backend="cuda")):
        svc = _svc(keys, spec=sp, shards=2, executor=executor)
        try:
            np.testing.assert_array_equal(svc.lookup(q), _oracle(keys, q))
        finally:
            svc.stop()


# ---------------------------------------------------------------------------
# one routed service per package for the edge cases and observability
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def routed_svc(amzn):
    keys, _ = amzn
    svc = _svc(keys, max_batch=2048, executor="sync", shards=4)
    yield svc
    svc.stop()


@pytest.fixture(scope="module")
def ref_routed_svc():
    keys = rsosd.generate("amzn", N_KEYS, seed=7)
    svc = RLookupService(keys, RLookupServiceConfig(
        spec=RIndexSpec("rmi", {}), max_batch=2048, deadline_ms=0.0,
        executor="sync", shards=4))
    yield svc
    svc.stop()


def test_queries_exactly_on_split_points(amzn, routed_svc):
    keys, _ = amzn
    splits = routed_svc.generation.topology.split_points
    q = np.concatenate([splits, splits - 1, splits + 1]).astype(np.uint64)
    np.testing.assert_array_equal(routed_svc.lookup(q), _oracle(keys, q))


def test_absent_keys_outside_global_range(amzn, routed_svc):
    keys, _ = amzn
    below = np.array([0, keys[0] - 1], dtype=np.uint64)
    above = np.array([keys[-1] + 1, 2**64 - 1], dtype=np.uint64)
    np.testing.assert_array_equal(routed_svc.lookup(below),
                                  np.zeros(2, dtype=np.int64))
    np.testing.assert_array_equal(routed_svc.lookup(above),
                                  np.full(2, keys.size, dtype=np.int64))


def test_batch_entirely_in_one_shard(amzn, routed_svc):
    keys, _ = amzn
    topo = routed_svc.generation.topology
    lo, hi = topo.offsets[2], topo.offsets[3]
    q = keys[np.random.default_rng(9).integers(lo, hi, 512)]
    np.testing.assert_array_equal(topo.route(q), np.full(512, 2))
    before = {r["shard"]: r["keys"] for r in routed_svc.metrics.per_shard()}
    np.testing.assert_array_equal(routed_svc.lookup(q), _oracle(keys, q))
    after = {r["shard"]: r["keys"] for r in routed_svc.metrics.per_shard()}
    for s in range(4):
        grew = after.get(s, 0) - before.get(s, 0)
        assert grew >= 512 if s == 2 else grew == 0


@pytest.mark.parametrize("executor", ["sync", "async"])
def test_single_shard_topology_degenerates_bit_exactly(amzn, executor):
    keys, q = amzn
    q = q[:1500]
    bcast = _svc(keys, executor=executor)
    one = _svc(keys, executor=executor,
               topology=ShardTopology.single(keys.size))
    try:
        np.testing.assert_array_equal(one.lookup(q), bcast.lookup(q))
        assert one.metrics.snapshot()["routed_batches"] >= 1
        assert bcast.metrics.snapshot()["routed_batches"] == 0
        # the one shard's health record equals the broadcast record
        rb = bcast.health.current()
        r1 = one.health.get(one.generation.shards[0].version)
        assert r1.shard == 0 and rb.shard is None
        for f in ("n", "disp_sum", "disp_max", "width_sum", "steps_sum"):
            assert getattr(r1, f) == getattr(rb, f), f
        np.testing.assert_array_equal(r1.disp_hist, rb.disp_hist)
        np.testing.assert_array_equal(r1.traffic_total, rb.traffic_total)
    finally:
        bcast.stop()
        one.stop()


@pytest.mark.parametrize("executor", ["sync", "async"])
def test_scan_windows_cross_shard_boundaries(amzn, ref_routed_svc,
                                             executor):
    """Windows anchored just below each split borrow the head of the
    NEXT shard: routed windows == broadcast windows == the reference's
    routed windows, uint64 with ``UINT64_MAX`` past the end."""
    keys, _ = amzn
    routed = _svc(keys, executor=executor, shards=4)
    bcast = _svc(keys, executor=executor)
    try:
        topo = routed.generation.topology
        anchors = np.array([keys[o - 3] for o in topo.offsets[1:-1]]
                           + [keys[10], keys[-2], keys[-1] + 1],
                           dtype=np.uint64)
        m = 64
        assert m <= routed.generation.max_scan_len
        fr = routed.scan(anchors, m)
        fb = bcast.scan(anchors, m)
        routed.drain()
        bcast.drain()
        pos_r, win_r = fr.result(timeout=30.0)
        pos_b, win_b = fb.result(timeout=30.0)
        assert win_r.dtype == np.uint64
        np.testing.assert_array_equal(pos_r, pos_b)
        np.testing.assert_array_equal(win_r, win_b)
        fref = ref_routed_svc.scan(anchors, m)
        ref_routed_svc.drain()
        pos_ref, win_ref = fref.result(timeout=30.0)
        np.testing.assert_array_equal(pos_r, pos_ref)
        np.testing.assert_array_equal(win_r, win_ref)
        assert win_r[-1, 0] == UINT64_MAX
        # a scan wider than the smallest shard is refused at admission
        with pytest.raises(ValueError, match="scan length"):
            routed.scan(anchors, routed.generation.max_scan_len + 1)
    finally:
        routed.stop()
        bcast.stop()


@pytest.mark.parametrize("executor", ["sync", "async"])
def test_hot_swap_routed_generation(amzn, executor):
    keys, _ = amzn
    svc = _svc(keys, spec=IndexSpec("pgm", {}), shards=3,
               executor=executor)
    try:
        old = svc.generation
        old_router = svc.batcher.router
        fresh = np.sort(np.random.default_rng(21).choice(
            2**48, size=30_000, replace=False).astype(np.uint64))
        svc.swap_keys(fresh)
        gen = svc.generation
        assert gen.version > old.version
        assert gen.topology.n_keys == fresh.size
        assert gen.topology is not old.topology
        assert svc.batcher.router is not old_router
        q = np.concatenate([fresh[::100], fresh[:5] + 1,
                            gen.topology.split_points]).astype(np.uint64)
        np.testing.assert_array_equal(svc.lookup(q), _oracle(fresh, q))
    finally:
        svc.stop()


def test_requests_routed_before_a_swap_are_rerouted(amzn):
    """A request tagged at admission against the old topology is routed
    again at dispatch (identity check), so it is answered exactly by
    the generation it runs on."""
    keys, q = amzn
    svc = _svc(keys, shards=4)
    fut = svc.submit(q[:300])
    assert svc.batcher._pending[0].route[0] is svc.generation.topology
    fresh = np.sort(np.random.default_rng(5).choice(
        2**50, size=20_000, replace=False).astype(np.uint64))
    svc.swap_keys(fresh)
    svc.drain()
    np.testing.assert_array_equal(fut.result(10.0), _oracle(fresh, q[:300]))


@pytest.mark.parametrize("executor", ["sync", "async"])
def test_replica_fanout_and_rebalance(amzn, executor):
    keys, q = amzn
    q = q[:1500]
    svc = _svc(keys, executor=executor, shards=2, replicas=2)
    try:
        assert svc.generation.topology.replicas == (2, 2)
        assert [len(g) for g in svc.dispatcher.lanes] == [2, 2]
        np.testing.assert_array_equal(svc.lookup(q), _oracle(keys, q))
        for i in range(0, 1500, 300):        # one batch each
            np.testing.assert_array_equal(svc.lookup(q[i:i + 300]),
                                          _oracle(keys, q[i:i + 300]))
        # round robin: both replicas of each shard took a sub-batch
        for grp in svc.dispatcher.lanes:
            assert all(lane.staging_allocs + lane.staging_hits > 0
                       for lane in grp)
        epoch = svc.dispatcher.lanes_epoch
        hot = keys[: keys.size // 8]
        svc.lookup(hot[np.random.default_rng(1).integers(0, hot.size,
                                                           4000)])
        reps = svc.rebalance_replicas(total_replicas=6, window_s=60.0)
        assert sum(reps) == 6 and min(reps) >= 1 and reps[0] > reps[1]
        assert svc.dispatcher.lanes_epoch == epoch + 1
        assert [len(g) for g in svc.dispatcher.lanes] == list(reps)
        # routes and results survive the fan-out change
        np.testing.assert_array_equal(svc.lookup(q), _oracle(keys, q))
        assert svc.rebalance_replicas(total_replicas=6,
                                      window_s=60.0) == reps
    finally:
        svc.stop()


def test_rebalance_needs_a_routed_topology(amzn):
    keys, _ = amzn
    svc = _svc(keys)
    with pytest.raises(ValueError, match="routed topology"):
        svc.rebalance_replicas()


def test_per_shard_tuned_specs(amzn):
    keys, q = amzn
    q = q[:1000]
    svc = _svc(keys, shards=2, shard_tuner=Tuner(names=("rmi", "pgm"),
                                                 max_configs=4))
    try:
        specs = [g.spec for g in svc.generation.shards]
        assert all(sp is not None for sp in specs)
        # each shard's spec is the tuner's choice over its own slice
        topo = svc.generation.topology
        for s, sp in enumerate(specs):
            sl = keys[topo.offsets[s]:topo.offsets[s + 1]]
            want = Tuner(names=("rmi", "pgm"), max_configs=4).tune(
                sl, device=CPU).spec
            assert sp.canonical() == want.canonical()
        np.testing.assert_array_equal(svc.lookup(q), _oracle(keys, q))
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# per-shard observability, against the reference's, and staging reuse
# ---------------------------------------------------------------------------
HEALTH_FIELDS = ("n", "disp_sum", "disp_max", "width_sum", "steps_sum")
MERGED_KEYS = ("health_n", "disp_mean", "disp_p50", "disp_p99", "disp_max",
               "build_disp_p99", "disp_p99_ratio", "bound_utilization_p99",
               "mean_bound_width", "mean_last_mile_steps", "drift_n",
               "health_shards", "generation_version")


@pytest.mark.parametrize("executor", ["sync", "async"])
def test_per_shard_health_and_metrics_match_reference(amzn, executor):
    keys, q = amzn
    rkeys = rsosd.generate("amzn", N_KEYS, seed=7)
    np.testing.assert_array_equal(keys, rkeys)
    svc = _svc(keys, executor=executor, shards=4, max_batch=2048)
    ref = RLookupService(rkeys, RLookupServiceConfig(
        spec=RIndexSpec("rmi", {}), max_batch=2048, deadline_ms=0.0,
        executor=executor, shards=4))
    try:
        for s in (svc, ref):
            for i in range(0, 4000, 500):
                s.lookup(q[i:i + 500])
        gp, gr = svc.generation, ref.registry.current()
        assert gp.shard_versions == gr.shard_versions
        for sp, sr in zip(gp.shards, gr.shards):
            assert sp.shard == sr.shard
            rp, rr = svc.health.get(sp.version), ref.health.get(sr.version)
            assert rp.shard == rr.shard == sp.shard
            for f in HEALTH_FIELDS:
                assert getattr(rp, f) == getattr(rr, f), f
            np.testing.assert_array_equal(rp.disp_hist, rr.disp_hist)
            np.testing.assert_array_equal(rp.traffic_total,
                                          rr.traffic_total)
            assert rp.record(60.0)["n_keys"] == rr.record(60.0)["n_keys"]
        hp, hr = svc.health_snapshot(60.0), ref.health_snapshot(60.0)
        assert hp["health_shards"] == 4.0
        for k in MERGED_KEYS:
            assert hp[k] == hr[k], k
        np.testing.assert_array_equal(svc.health.global_traffic_hist(60.0),
                                      ref.health.global_traffic_hist(60.0))
        vp = [gp.version] + list(gp.shard_versions)
        vr = [gr.version] + list(gr.shard_versions)
        assert svc.health.merged_snapshot(vp[1:], 60.0)["health_n"] == \
            ref.health.merged_snapshot(vr[1:], 60.0)["health_n"]
        mp, mr = svc.metrics.snapshot(), ref.metrics.snapshot()
        for k in ("routed_batches", "route_shards", "route_skew",
                  "route_max_skew", "batches", "lookups"):
            assert mp[k] == mr[k], k
        assert svc.metrics.per_shard() == ref.metrics.per_shard()
    finally:
        svc.stop()
        ref.stop()


def test_per_shard_metrics_health_and_prometheus(amzn, routed_svc):
    keys, q = amzn
    routed_svc.lookup(q[:2000])
    snap = routed_svc.metrics.snapshot()
    assert snap["routed_batches"] >= 1
    assert snap["route_shards"] == 4
    assert snap["route_skew"] >= 1.0
    rows = routed_svc.metrics.per_shard()
    assert {r["shard"] for r in rows} == set(range(4))
    assert all(r["keys"] > 0 for r in rows)
    h = routed_svc.health_snapshot(window_s=60.0)
    assert h["health_shards"] == 4.0
    recs = routed_svc.registry.health_records(60.0)
    by_shard = {r["shard"]: r for r in recs if "shard" in r}
    assert set(by_shard) == set(range(4))
    assert sum(r["n_keys"] for r in by_shard.values()) == keys.size
    payload = metrics_payload(routed_svc)
    assert {r["shard"] for r in payload["per_shard"]} == set(range(4))
    server = MetricsServer(routed_svc)
    try:
        text = server.render_prometheus()
        for s in range(4):
            assert f'repro_lookup_shard_keys{{shard="{s}"}}' in text
    finally:
        server._httpd.server_close()


def test_pinned_staging_reuse_steady_state(amzn, routed_svc):
    keys, _ = amzn
    q = keys[np.random.default_rng(13).integers(0, keys.size, 300)]
    routed_svc.lookup(q)
    allocs = routed_svc.dispatcher.staging_allocs
    hits = routed_svc.dispatcher.staging_hits
    for _ in range(5):
        routed_svc.lookup(q)
    assert routed_svc.dispatcher.staging_allocs == allocs
    assert routed_svc.dispatcher.staging_hits > hits


def test_async_routed_ring_returns_every_host_set(amzn):
    """A routed slot takes one pinned host set per lane it launches on
    and gives them all back when it completes: after a drained burst
    the free list holds as many sets as were ever taken."""
    keys, q = amzn
    svc = _svc(keys, executor="async", shards=4, max_batch=256, slots=2)
    reqs = [q[i:i + 97] for i in range(0, 4000, 97)]
    with svc:
        futs = [svc.submit(r) for r in reqs]
        got = [f.result(30.0) for f in futs]
    np.testing.assert_array_equal(np.concatenate(got),
                                  _oracle(keys, np.concatenate(reqs)))
    free = svc._async._free_hosts
    # a full ring (slots) plus one completing plus one launching, each
    # holding up to one set per shard
    assert 4 <= len(free) <= (2 + 2) * 4
