"""The port's lookup service against the reference's sync service.

Batcher policy cases mirror `tests/test_serve_lookup.py`; the service
(CPU, both backends, the kernels' plain versions behind ``"cuda"``)
returns the reference's positions and scan windows bit for bit on the
four surrogates, with the same health stats; plus hot swap under load,
the atomic registry swap, padding and staging, the refusals of invalid
routed configs, and the serve driver on the CPU (broadcast, routed and
with the autotune daemon).
"""
import jax

jax.config.update("jax_enable_x64", True)

import functools
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.data import sosd as rsosd
from repro.serve.lookup import LookupService as RLookupService
from repro.serve.lookup import LookupServiceConfig as RLookupServiceConfig
from repro_torch.core import base, spec
from repro_torch.data import sosd
from repro_torch.kernels.common import encode_keys
from repro_torch.serve.lookup import (DEFAULT_HYPER, ClientBacklogFull,
                                      IndexRegistry, LookupService,
                                      LookupServiceConfig, MicroBatcher,
                                      MutableLookupService,
                                      MutableLookupServiceConfig,
                                      ShardedDispatcher, default_spec)

CPU = "cpu"


# ---------------------------------------------------------------------------
# micro-batcher flush policy
# ---------------------------------------------------------------------------
def test_batcher_flushes_on_size():
    b = MicroBatcher(max_batch=100, deadline_s=60.0)
    for _ in range(3):
        b.submit(np.arange(40, dtype=np.uint64) + 1)
    assert b.ready()
    batch = b.take()
    assert [r.keys.size for r in batch] == [40, 40]
    assert [r.rid for r in batch] == sorted(r.rid for r in batch)
    assert b.pending_keys == 40


def test_batcher_flushes_on_deadline():
    b = MicroBatcher(max_batch=10_000, deadline_s=0.05)
    b.submit(np.arange(5, dtype=np.uint64) + 1)
    assert not b.ready()
    assert b.take() == []
    assert b.wait_ready(timeout=30.0)      # the deadline fires
    batch = b.take()
    assert len(batch) == 1 and batch[0].keys.size == 5
    assert b.pending_keys == 0


def test_batcher_oversize_request_not_split():
    b = MicroBatcher(max_batch=8, deadline_s=60.0)
    b.submit(np.arange(50, dtype=np.uint64) + 1)
    batch = b.take()
    assert len(batch) == 1 and batch[0].keys.size == 50


def test_batcher_wait_ready_wakes_on_submit():
    b = MicroBatcher(max_batch=4, deadline_s=60.0)
    waiting = threading.Event()

    def feed():
        waiting.wait(5.0)
        b.submit(np.arange(4, dtype=np.uint64) + 1)

    t = threading.Thread(target=feed)
    t.start()
    waiting.set()
    assert b.wait_ready(timeout=30.0)      # size trigger, not the deadline
    t.join(timeout=30.0)
    assert not t.is_alive()


def test_batcher_wait_ready_until_returns_on_wake():
    b = MicroBatcher(max_batch=4, deadline_s=60.0)
    stop = threading.Event()
    out = []
    t = threading.Thread(target=lambda: out.append(
        b.wait_ready(until=stop.is_set)))
    t.start()
    stop.set()
    b.wake()
    t.join(timeout=30.0)
    assert not t.is_alive() and out == [False]


def test_batcher_rejects_empty_and_bad_config():
    b = MicroBatcher(max_batch=4, deadline_s=1.0)
    with pytest.raises(ValueError):
        b.submit(np.array([], np.uint64))
    for kw in (dict(max_batch=0), dict(max_client_keys=0),
               dict(client_rate=(0.0, 10)), dict(client_rate=(5.0, 0)),
               dict(class_deadlines={"batch": 0.0})):
        with pytest.raises(ValueError):
            MicroBatcher(**{"max_batch": 4, "deadline_s": 1.0, **kw})


def test_batcher_copies_the_client_buffer():
    b = MicroBatcher(max_batch=100, deadline_s=60.0)
    buf = np.arange(8, dtype=np.uint64)
    b.submit(buf)
    buf[:] = 99
    np.testing.assert_array_equal(b.take(force=True)[0].keys, np.arange(8))


def test_batcher_per_client_pending_cap():
    b = MicroBatcher(max_batch=10_000, deadline_s=60.0, max_client_keys=100)
    b.submit(np.arange(60, dtype=np.uint64) + 1, client="a")
    b.submit(np.arange(60, dtype=np.uint64) + 1, client="b")
    with pytest.raises(ClientBacklogFull):
        b.submit(np.arange(50, dtype=np.uint64) + 1, client="a")
    assert b.pending_keys_of("a") == 60
    b.submit(np.arange(500, dtype=np.uint64) + 1)    # anonymous: uncapped
    assert b.pending_requests == 3
    assert len(b.take(force=True)) == 3
    assert b.pending_keys_of("a") == 0
    b.submit(np.arange(100, dtype=np.uint64) + 1, client="a")


def test_batcher_cap_disabled_by_default():
    b = MicroBatcher(max_batch=16, deadline_s=60.0)
    for _ in range(5):
        b.submit(np.arange(64, dtype=np.uint64) + 1, client="hog")
    assert b.pending_requests == 5


def test_batcher_token_bucket_rejects_over_burst():
    b = MicroBatcher(max_batch=10_000, deadline_s=60.0,
                     client_rate=(1.0, 100))
    b.submit(np.arange(90, dtype=np.uint64) + 1, client="a")
    with pytest.raises(ClientBacklogFull):
        b.submit(np.arange(50, dtype=np.uint64) + 1, client="a")
    b.submit(np.arange(90, dtype=np.uint64) + 1, client="b")
    b.submit(np.arange(500, dtype=np.uint64) + 1)
    assert b.pending_requests == 3
    b.take(force=True)                     # a flush returns no tokens
    with pytest.raises(ClientBacklogFull):
        b.submit(np.arange(50, dtype=np.uint64) + 1, client="a")


def test_batcher_token_bucket_refills_at_rate():
    b = MicroBatcher(max_batch=10_000, deadline_s=60.0,
                     client_rate=(10_000.0, 64))
    b.submit(np.arange(64, dtype=np.uint64) + 1, client="a")
    deadline = time.perf_counter() + 30.0
    while True:
        try:
            b.submit(np.arange(64, dtype=np.uint64) + 1, client="a")
            break
        except ClientBacklogFull:
            assert time.perf_counter() < deadline, "bucket never refilled"
            time.sleep(0.001)
    assert b.pending_requests == 2


def test_batcher_cap_rejection_burns_no_tokens():
    b = MicroBatcher(max_batch=10_000, deadline_s=60.0,
                     max_client_keys=50, client_rate=(1.0, 1000))
    with pytest.raises(ClientBacklogFull):
        b.submit(np.arange(60, dtype=np.uint64) + 1, client="a")
    b.submit(np.arange(50, dtype=np.uint64) + 1, client="a")
    assert b.pending_requests == 1


def test_batcher_class_deadlines_pick_the_earliest():
    b = MicroBatcher(max_batch=10_000, deadline_s=60.0,
                     class_deadlines={"interactive": 0.05, "batch": 60.0})
    assert b.deadline_for("interactive") == 0.05
    assert b.deadline_for("unknown") == 60.0
    b.submit(np.arange(4, dtype=np.uint64) + 1, priority="batch")
    assert not b.ready()
    b.submit(np.arange(4, dtype=np.uint64) + 1, priority="interactive")
    assert b.wait_ready(timeout=30.0)      # the interactive budget fires
    batch = b.take()
    assert [r.priority for r in batch] == ["batch", "interactive"]


# ---------------------------------------------------------------------------
# dispatcher: padding, staging, finalize
# ---------------------------------------------------------------------------
def test_dispatcher_padded_size_buckets():
    d = ShardedDispatcher(device=CPU)
    assert d.n_shards == 1
    assert d.padded_size(1) == d.pad_quantum == 128
    assert d.padded_size(128) == 128
    assert d.padded_size(129) == 256
    for m in (1, 7, 511, 513, 4096, 4097):
        p = d.padded_size(m)
        assert p >= m and p & (p - 1) == 0
    assert ShardedDispatcher(device=CPU, pad_quantum=32).padded_size(3) == 32


def test_staging_buffer_never_aliases_a_placed_batch():
    """Back-to-back batches of one bucket reuse its staging buffer; every
    placed batch keeps its own encoded keys and pads with its first."""
    d = ShardedDispatcher(device=CPU)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 2**64 - 1, int(rng.integers(257, 513)),
                            dtype=np.uint64) for _ in range(8)]
    placed = [d.pad_and_place(q) for q in batches]
    assert d.staging_allocs == 1 and d.staging_hits == 7
    for q, ((qt,), p) in zip(batches, placed):
        assert p == 512 and qt.dtype == torch.int64
        want = np.concatenate([q, np.full(p - q.size, q[0], np.uint64)])
        assert torch.equal(qt, encode_keys(want, CPU))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_dispatcher_runs_a_plan_or_a_callable(backend):
    from repro_torch.core import plan as plan_mod

    keys = sosd.generate("face", 6_000, seed=2)
    q = sosd.make_queries(keys, 300, seed=3)
    p = plan_mod.lower(spec.build(spec.IndexSpec("pgm"), keys, device=CPU),
                       encode_keys(keys, CPU))
    d = ShardedDispatcher(device=CPU)
    lb = np.searchsorted(keys, q)
    np.testing.assert_array_equal(d(p, q, backend=backend), lb)
    pos, win = d(p.compile_scan(4, backend), q)
    np.testing.assert_array_equal(pos, lb)
    assert win.dtype == np.uint64 and win.shape == (300, 4)
    pos, stats = d(p.compile_instrumented(backend), q, n_valid_arg=True)
    np.testing.assert_array_equal(pos, lb)
    assert stats.shape == (93,) and stats[0] == 300   # pad lanes masked


def test_finalize_decodes_windows_and_keeps_stats_whole():
    pos = torch.arange(6, dtype=torch.int64)
    win = encode_keys(np.array([[1, 2], [3, 2**64 - 1]] * 3, np.uint64), CPU)
    got = ShardedDispatcher.finalize((pos, win), 4)
    assert got[0].dtype == np.int64 and got[0].tolist() == [0, 1, 2, 3]
    assert got[1].dtype == np.uint64 and got[1].shape == (4, 2)
    assert got[1][1, 1] == np.uint64(2**64 - 1)
    stats = torch.arange(93, dtype=torch.int64)
    out, st = ShardedDispatcher.finalize((pos, stats), 2, instrumented=True)
    assert out.tolist() == [0, 1] and st.shape == (93,)
    assert ShardedDispatcher.finalize(pos, 3).tolist() == [0, 1, 2]


# ---------------------------------------------------------------------------
# the service against the reference's sync service
# ---------------------------------------------------------------------------
N_KEYS = 20_000
SERVICE_INDEXES = [("rmi", dict(branching=512)), ("pgm", dict(eps=32))]
COUNT_KEYS = ("health_n", "disp_mean", "disp_p50", "disp_p99", "disp_max",
              "build_disp_p99", "disp_p99_ratio", "bound_utilization_p99",
              "mean_bound_width", "mean_last_mile_steps", "batches",
              "requests", "lookups", "mean_occupancy")


def _traffic(svc, q):
    """Reads of several sizes, scans of two lengths and reads again, in
    one admission order; drained; the futures' results in order."""
    futs = [svc.submit(q[i:i + 97]) for i in range(0, 1_940, 97)]
    futs += [svc.scan(q[i:i + 40], 8 if i % 80 else 3)
             for i in range(2_000, 2_800, 40)]
    futs += [svc.submit(q[i:i + 301]) for i in range(3_000, 4_505, 301)]
    svc.drain()
    return [f.result(30.0) for f in futs]


@functools.lru_cache(maxsize=None)
def _reference_run(ds: str, index: str):
    keys = rsosd.generate(ds, N_KEYS, seed=7)
    q = rsosd.make_queries(keys, 5_000, seed=11, present_frac=0.6)
    q[:3] = [0, 2**64 - 1, keys[-1]]
    svc = RLookupService(keys, RLookupServiceConfig(
        index=index, hyper=dict(SERVICE_INDEXES)[index], max_batch=1024))
    out = _traffic(svc, q)
    rec = svc.health.current()
    return keys, q, out, svc.health_snapshot(), rec, svc.metrics.snapshot()


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("index", [n for n, _ in SERVICE_INDEXES])
@pytest.mark.parametrize("ds", ["amzn", "face", "osm", "wiki"])
def test_service_matches_reference_sync_service(ds, index, backend):
    keys, q, ref_out, ref_h, ref_rec, ref_m = _reference_run(ds, index)
    svc = LookupService(keys, LookupServiceConfig(
        index=index, hyper=dict(SERVICE_INDEXES)[index], backend=backend,
        max_batch=1024), device=CPU)
    assert svc.generation.spec.backend == backend
    out = _traffic(svc, q)
    assert len(out) == len(ref_out)
    for got, want in zip(out, ref_out):
        if isinstance(want, tuple):          # scan: (positions, window)
            assert got[0].dtype == np.int64 and got[1].dtype == np.uint64
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        else:
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, want)
    reads = np.concatenate([o for o in out if not isinstance(o, tuple)])
    read_q = np.concatenate([q[i:i + 97] for i in range(0, 1_940, 97)]
                            + [q[i:i + 301] for i in range(3_000, 4_505, 301)])
    np.testing.assert_array_equal(reads, np.searchsorted(keys, read_q))
    # the health stats, element for element, and the snapshot keys
    h = svc.health_snapshot()
    assert set(h) == set(ref_h)
    for k in COUNT_KEYS:
        assert h[k] == ref_h[k], k
    rec = svc.health.current()
    for f in ("n", "disp_sum", "disp_max", "width_sum", "steps_sum"):
        assert getattr(rec, f) == getattr(ref_rec, f), f
    np.testing.assert_array_equal(rec.disp_hist, ref_rec.disp_hist)
    np.testing.assert_array_equal(rec.traffic_total, ref_rec.traffic_total)
    assert set(svc.metrics.snapshot()) == set(ref_m)
    for k in ("cache_hits", "cache_misses", "cache_accesses",
              "warm_compiles", "max_inflight_slots"):
        assert svc.metrics.snapshot()[k] == ref_m[k] == 0


def test_health_off_reads_the_plain_lookup_and_reports_zeros():
    keys = sosd.generate("osm", N_KEYS, seed=7)
    q = sosd.make_queries(keys, 3_000, seed=1)
    on = LookupService(keys, LookupServiceConfig(index="pgm"), device=CPU)
    off = LookupService(keys, LookupServiceConfig(index="pgm", health=False),
                        device=CPU)
    assert off.health is None and off.registry.health_records() == []
    lookup_fns, _, _ = off._pin_context()
    assert lookup_fns == (off.generation.fn,)
    np.testing.assert_array_equal(on.lookup(q), off.lookup(q))
    snap = off.health_snapshot()
    assert "health_n" not in snap and snap["serving"] == 0.0
    assert on.health_snapshot()["health_n"] == len(q)


@pytest.fixture(scope="module")
def amzn_service():
    keys = sosd.generate("amzn", 50_000, seed=3)
    svc = LookupService(keys, LookupServiceConfig(
        index="rmi", hyper=dict(branching=1024), max_batch=512,
        deadline_ms=5.0, trace=True), device=CPU)
    yield keys, svc
    svc.stop()


def test_service_fifo_completion_per_client(amzn_service):
    keys, svc = amzn_service
    q = sosd.make_queries(keys, 6_400, seed=5)
    per_client = {}
    lock = threading.Lock()

    def client(cid):
        rng = np.random.default_rng(cid)
        futs = []
        for i in range(20):
            m = int(rng.integers(8, 120))
            futs.append(svc.submit(q[(cid * 20 + i) * 8:][:m], client=cid))
        with lock:
            per_client[cid] = futs

    with svc:
        ts = [threading.Thread(target=client, args=(c,)) for c in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60.0)
        for futs in per_client.values():
            for i, f in enumerate(futs):
                f.result(timeout=30.0)
                assert all(g.done() for g in futs[:i])
    status, doc = svc.health_status()
    assert status == 503 and doc["serving"] is False   # stopped
    spans = svc.recorder.to_chrome()
    assert len(svc.recorder.request_latencies_s(spans)) >= 60


def test_service_deadline_flush_completes_small_request(amzn_service):
    keys, svc = amzn_service
    with svc:
        status, doc = svc.health_status()
        pos = svc.submit(keys[:7]).result(timeout=30.0)
    assert status == 200 and doc["status"] == "ok"
    np.testing.assert_array_equal(pos, np.arange(7))


def test_lookup_convenience_and_scan_admission(amzn_service):
    keys, svc = amzn_service
    np.testing.assert_array_equal(svc.lookup(keys[10:20]), np.arange(10, 20))
    for bad in (0, svc.cfg.max_scan_length + 1):
        with pytest.raises(ValueError, match="scan length"):
            svc.scan(keys[:4], bad)
    hashed = LookupService(keys, LookupServiceConfig(index="robin_hash"),
                           device=CPU)
    with pytest.raises(ValueError, match="point-only"):
        hashed.scan(keys[:4], 4)
    np.testing.assert_array_equal(hashed.lookup(keys[:5]), np.arange(5))


def test_service_hot_swap_under_load():
    keys_old = sosd.generate("face", 30_000, seed=1)
    keys_new = sosd.generate("osm", 30_000, seed=2)
    svc = LookupService(keys_old, LookupServiceConfig(
        index="radix_spline", hyper=dict(eps=32, radix_bits=12),
        backend="cuda", max_batch=256, deadline_ms=1.0), device=CPU)
    key_sets = {0: keys_old, 1: keys_new}
    bad = []
    midstream = threading.Event()

    def client():
        rng = np.random.default_rng(0)
        for i in range(60):
            q = rng.integers(1, 1 << 62, size=32, dtype=np.uint64)
            v_before = svc.generation.version
            pos = svc.submit(q).result(timeout=30.0)
            v_after = svc.generation.version
            if not any(np.array_equal(pos, np.searchsorted(key_sets[v], q))
                       for v in range(v_before, v_after + 1)):
                bad.append(i)
            if i == 20:
                midstream.set()

    with svc:
        t = threading.Thread(target=client)
        t.start()
        assert midstream.wait(timeout=60.0)
        gen = svc.swap_keys(keys_new)        # no drain, mid-stream
        t.join(timeout=60.0)
    assert not t.is_alive()
    assert not bad
    assert gen.version == svc.generation.version == 1
    assert gen.spec.backend == "cuda"
    assert [r["generation_version"] for r in
            svc.registry.health_records()] == [0.0, 1.0]


def test_registry_swap_is_atomic_never_half_built():
    keys_old = sosd.generate("amzn", 10_000, seed=1)
    keys_new = sosd.generate("wiki", 10_000, seed=2)
    reg = IndexRegistry(device=CPU)
    g0 = reg.build_and_publish("rmi", keys_old, hyper=dict(branching=256))
    in_build = threading.Event()
    release = threading.Event()

    @base.register("_test_slow_rmi")
    def slow_build(keys, **hyper):
        in_build.set()
        assert release.wait(10.0)
        return base.REGISTRY["rmi"](keys, **hyper)

    spec.register_schema("_test_slow_rmi", fields=spec.SCHEMAS["rmi"].fields,
                         ladder=[dict()])
    try:
        t = threading.Thread(target=reg.build_and_publish, args=(
            "_test_slow_rmi", keys_new),
            kwargs=dict(hyper=dict(branching=256)))
        t.start()
        assert in_build.wait(10.0)
        cur = reg.current()                  # mid-build: the old one
        assert cur.version == g0.version
        q = sosd.make_queries(keys_old, 200, seed=3)
        np.testing.assert_array_equal(cur.fn(encode_keys(q, CPU)).numpy(),
                                      np.searchsorted(keys_old, q))
        release.set()
        t.join(timeout=30.0)
        assert not t.is_alive()
        assert reg.current().version > g0.version
        assert reg.current().n_keys == len(keys_new)
    finally:
        release.set()
        base.REGISTRY.pop("_test_slow_rmi", None)
        spec.SCHEMAS.pop("_test_slow_rmi", None)


def test_registry_publish_paths_carry_the_spec():
    keys = sosd.generate("osm", 8_000, seed=4)
    reg = IndexRegistry(device=CPU)
    seen = []
    reg.subscribe(lambda name, gen: seen.append((name, gen.version)))
    sp = spec.IndexSpec("pgm", {"eps": 16}, backend="cuda")
    g0 = reg.build_and_publish(sp, keys)
    assert g0.spec == sp.validated() and g0.backend == "cuda"
    with pytest.raises(TypeError):
        reg.build_and_publish(sp, keys, hyper={"eps": 8})
    b = spec.build(spec.IndexSpec("rmi", {"branching": 64}), keys, device=CPU)
    g1 = reg.make_generation(b, encode_keys(keys, CPU), last_mile="linear")
    assert reg.current().version == g0.version     # not yet published
    assert reg.publish_prebuilt(g1, name="other") is g1
    assert reg.current("other").spec.last_mile == "linear"
    assert g1.fn_for(donate=True) is g1.fn
    q = sosd.make_queries(keys, 500, seed=5)
    qt = encode_keys(q, CPU)
    pos, stats = g1.instrumented_fn()(qt, 500)
    np.testing.assert_array_equal(pos.numpy(), np.searchsorted(keys, q))
    assert stats.shape == (93,) and int(stats[0]) == 500
    np.testing.assert_array_equal(g1.scan_fn(4)(qt)[0].numpy(), pos.numpy())
    assert seen == [("default", g0.version), ("other", g1.version)]
    with pytest.raises(KeyError):
        reg.current("missing")


def test_default_spec_and_config_match_reference():
    import dataclasses

    assert DEFAULT_HYPER == {
        k: dict(v) for k, v in __import__(
            "repro.serve.lookup", fromlist=["DEFAULT_HYPER"]
        ).DEFAULT_HYPER.items()}
    ref = {f.name: f.default for f in
           dataclasses.fields(RLookupServiceConfig)}
    port = {f.name: f.default for f in dataclasses.fields(LookupServiceConfig)}
    assert set(port) == set(ref)
    ref["backend"] = "torch"                   # the port's backend axis
    for name, default in port.items():
        if default is not dataclasses.MISSING:
            assert default == ref[name], name
    sp = default_spec("rmi", backend="cuda")
    assert sp.hyper["branching"] == 4096 and sp.backend == "cuda"
    cfg = LookupServiceConfig(index="pgm", hyper={"eps": 8}, spec=sp)
    assert cfg.resolved_spec() == sp           # the spec wins wholesale


def _reference_refusal(case, keys):
    from repro.serve.lookup import MutableLookupService as RMutable
    from repro.serve.lookup import MutableLookupServiceConfig as RMutCfg
    from repro.serve.lookup import ShardTopology as RShardTopology
    if case == "shards0":
        RShardTopology.from_keys(keys, 0)
    elif case == "replicas0":
        RShardTopology.from_keys(keys, 1, 0)
    elif case == "shards2_replicas0":
        RLookupService(keys, RLookupServiceConfig(shards=2, replicas=0))
    else:
        RMutable(keys, RMutCfg(shards=2))


@pytest.mark.parametrize("case,make", [
    ("shards0", lambda k: LookupService(
        k, LookupServiceConfig(shards=0), device=CPU)),
    ("replicas0", lambda k: LookupService(
        k, LookupServiceConfig(replicas=0), device=CPU)),
    ("shards2_replicas0", lambda k: LookupService(
        k, LookupServiceConfig(shards=2, replicas=0), device=CPU)),
    ("mutable_shards2", lambda k: MutableLookupService(
        k, MutableLookupServiceConfig(shards=2), device=CPU)),
])
def test_invalid_routed_configs_raise_the_references_value_error(case, make):
    """Shard or replica counts below one, and a mutable service over a
    routed topology, raise the reference's own ValueError (its topology's
    message for the counts; the port refuses them even where the
    reference's broadcast path would ignore them)."""
    keys = np.arange(1, 1_001, dtype=np.uint64)
    with pytest.raises(ValueError) as ref_err:
        _reference_refusal(case, keys)
    with pytest.raises(ValueError) as err:
        make(keys)
    assert str(err.value) == str(ref_err.value)


def test_unknown_executor_is_a_value_error():
    with pytest.raises(ValueError, match="executor"):
        LookupService(np.arange(1, 100, dtype=np.uint64),
                      LookupServiceConfig(executor="threads"), device=CPU)


def test_failed_group_fails_its_futures_not_the_flusher():
    keys = sosd.generate("wiki", 5_000, seed=1)
    svc = LookupService(keys, LookupServiceConfig(index="pgm"), device=CPU)

    def refuse(m, backend="torch"):
        raise ValueError("scan refused")

    # making the group's callable fails inside the guard
    object.__setattr__(svc.generation.plan, "compile_scan", refuse)
    first = svc.submit(keys[:2])
    fut = svc.scan(keys[:4], 4)
    ok = svc.submit(keys[:3])
    assert svc.drain() == 1
    with pytest.raises(ValueError, match="scan refused"):
        fut.result(5.0)
    np.testing.assert_array_equal(first.result(5.0), np.arange(2))
    np.testing.assert_array_equal(ok.result(5.0), np.arange(3))
    assert svc.metrics.snapshot()["requests"] == 2


# ---------------------------------------------------------------------------
# the serve driver
# ---------------------------------------------------------------------------
def _driver(*args):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], env=env,
        capture_output=True, text=True, timeout=300)


def test_driver_on_the_cpu_passes_doctor(tmp_path):
    trace_out = str(tmp_path / "trace.json")
    out = _driver("--mode", "lookup", "--device", "cpu", "--doctor",
                  "--n-keys", "30000", "--requests", "40",
                  "--spec", '{"index": "pgm", "hyper": {"eps": 64}, '
                            '"backend": "cuda"}',
                  "--trace-out", trace_out)
    assert out.returncode == 0, out.stderr
    lines = out.stdout
    assert '"backend": "cuda"' in lines and "device=cpu" in lines
    assert "2560 lookups / 40 requests" in lines
    assert "health: disp p99" in lines
    assert "alerts: none firing" in lines
    assert "exact vs lower_bound oracle: True" in lines
    assert os.path.getsize(trace_out) > 0


def test_driver_routed_with_replicas_passes_doctor():
    out = _driver("--mode", "lookup", "--device", "cpu", "--doctor",
                  "--n-keys", "30000", "--requests", "40",
                  "--shards", "2", "--replicas", "2")
    assert out.returncode == 0, out.stderr
    assert "'n_shards': 2" in out.stdout and "'replicas': [2, 2]" in out.stdout
    assert "over 2 shard(s)" in out.stdout
    assert "exact vs lower_bound oracle: True" in out.stdout


def test_driver_autotune_daemon_passes_doctor(tmp_path):
    out = _driver("--mode", "lookup", "--device", "cpu", "--doctor",
                  "--n-keys", "30000", "--requests", "40",
                  "--autotune-daemon", "--autotune-store",
                  str(tmp_path / "store"))
    assert out.returncode == 0, out.stderr
    assert "autotune: daemon=up" in out.stdout
    assert "exact vs lower_bound oracle: True" in out.stdout
    assert os.path.isdir(tmp_path / "store")


def test_driver_refuses_what_waits_for_later_items():
    out = _driver("--executor", "threads", "--device", "cpu")
    assert out.returncode == 2 and "invalid choice" in out.stderr
