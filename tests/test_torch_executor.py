"""The port's async executor against its sync path and the reference.

Parity: the port's async service, its sync service, and the reference's
``jnp`` sync and async services return the same positions, uint64 scan
windows and health stats bit for bit (rmi, pgm, radix_spline x the
port's ``torch`` and ``cuda`` backends; on the CPU ``cuda`` runs the
kernels' plain versions).  Then the reference's executor cases
(`tests/test_serve_executor.py`) on the port: the replay oracle with
compactions, concurrent clients, FIFO completion, the slot ring, inline
drain, stop and straggler, result timeout, the executable cache, hot
swap, and the three fault injections, each failing only its own batch.
On the CPU every executable is the plan's callable as it is; graph
capture runs on the card (`tests/test_torch_cuda.py`).
"""
import jax

jax.config.update("jax_enable_x64", True)

import functools
import threading
import time

import numpy as np
import pytest

from repro.data import sosd as rsosd
from repro.serve.lookup import LookupService as RLookupService
from repro.serve.lookup import LookupServiceConfig as RLookupServiceConfig
from repro_torch.core import base
from repro_torch.data import sosd
from repro_torch.serve.lookup import (AsyncExecutor, ExecutableCache,
                                      LookupService, LookupServiceConfig,
                                      MutableLookupService,
                                      MutableLookupServiceConfig)
from repro_torch.serve.lookup.executor import WorkItem
from repro_torch.workloads import replay as replay_mod
from repro_torch.workloads.workload import OP_INSERT, make_workload

CPU = "cpu"
UINT64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.fixture(scope="module")
def cell():
    keys = sosd.generate("amzn", 20_000, seed=3)
    q = sosd.make_queries(keys, 2_000, seed=5, present_frac=0.6)
    return keys, q, base.lower_bound_oracle(keys, q)


def _scan_oracle(keys, pos, m):
    w = np.full((pos.size, m), UINT64_MAX, dtype=np.uint64)
    for i, p in enumerate(pos):
        seg = keys[p:p + m]
        w[i, :seg.size] = seg
    return w


def _svc(keys, executor, **over):
    kw = dict(index="rmi", hyper=dict(branching=512), max_batch=256,
              deadline_ms=1.0, executor=executor)
    kw.update(over)
    return LookupService(keys, LookupServiceConfig(**kw), device=CPU)


# ---------------------------------------------------------------------------
# parity: port async == port sync == reference jnp sync and async
# ---------------------------------------------------------------------------
PARITY = {"rmi": dict(branching=512), "pgm": dict(eps=32),
          "radix_spline": dict(eps=32, radix_bits=12)}


def _parity_traffic(svc, q):
    with svc:
        reads = [svc.submit(q[i:i + 97]) for i in range(0, q.size, 97)]
        scans = [svc.scan(q[i:i + 50], 16) for i in range(0, 200, 50)]
        out = ([f.result(60.0) for f in reads],
               [f.result(60.0) for f in scans])
    rec = svc.health.current()
    stats = {f: getattr(rec, f) for f in ("n", "disp_sum", "disp_max",
                                          "width_sum", "steps_sum")}
    stats["disp_hist"] = np.asarray(rec.disp_hist).copy()
    stats["traffic_total"] = np.asarray(rec.traffic_total).copy()
    return out, stats


@functools.lru_cache(maxsize=None)
def _reference_run(index, executor):
    keys = rsosd.generate("amzn", 20_000, seed=3)
    q = rsosd.make_queries(keys, 2_000, seed=5, present_frac=0.6)
    svc = RLookupService(keys, RLookupServiceConfig(
        index=index, hyper=PARITY[index], max_batch=256, deadline_ms=1.0,
        executor=executor, warm_scan_lengths=(16,)))
    return _parity_traffic(svc, q)


def _assert_same(a, b):
    (ra, sa), ha = a
    (rb, sb), hb = b
    np.testing.assert_array_equal(np.concatenate(ra), np.concatenate(rb))
    for (pa, wa), (pb, wb) in zip(sa, sb):
        assert pa.dtype == pb.dtype == np.int64
        assert wa.dtype == wb.dtype == np.uint64
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(wa, wb)
    assert set(ha) == set(hb)
    for k in ha:
        np.testing.assert_array_equal(ha[k], hb[k], err_msg=k)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("index", sorted(PARITY))
def test_async_matches_sync_and_the_reference_bit_for_bit(cell, index,
                                                          backend):
    keys, q, lb = cell
    runs = {}
    for executor in ("sync", "async"):
        svc = _svc(keys, executor, index=index, hyper=PARITY[index],
                   backend=backend, warm_scan_lengths=(16,))
        runs[executor] = _parity_traffic(svc, q)
    _assert_same(runs["async"], runs["sync"])
    _assert_same(runs["async"], _reference_run(index, "sync"))
    _assert_same(runs["async"], _reference_run(index, "async"))
    np.testing.assert_array_equal(np.concatenate(runs["async"][0][0]), lb)
    w0 = runs["async"][0][1][0][1]
    np.testing.assert_array_equal(w0, _scan_oracle(keys, lb[:50], 16))


def test_async_replay_matches_oracle_with_compactions(cell):
    """Mixed trace, async executor, compactions racing the slot ring:
    positions, admitted flags, AND scan windows equal the oracle's."""
    keys, _, _ = cell
    wl = make_workload(keys, 600,
                       mix={"read": 0.5, "insert": 0.3, "range": 0.2},
                       seed=17, range_len=16)
    want, want_win = replay_mod.oracle_scan_replay(keys, wl)
    svc = MutableLookupService(keys, MutableLookupServiceConfig(
        index="pgm", hyper=dict(eps=32), max_batch=256, deadline_ms=1.0,
        executor="async", compact_threshold=512, warm_scan_lengths=(16,)),
        device=CPU)
    with svc:
        got, got_win = replay_mod.replay_on_service(
            wl, svc, chunk=48, compact_every=200, scan_ranges=True)
        assert (want[wl.ops == OP_INSERT] == 1).any()
        if svc.mindex.delta_count:
            svc.force_compact()
        assert svc.metrics.snapshot()["compactions"] >= 1
        merged = np.union1d(keys, wl.keys[(wl.ops == OP_INSERT)
                                          & (want == 1)])
        probe = wl.keys[wl.ops != OP_INSERT][:300]
        np.testing.assert_array_equal(
            svc.lookup(probe, timeout=60.0),
            base.lower_bound_oracle(merged, probe))
    np.testing.assert_array_equal(got, want)
    assert set(got_win) == set(want_win)
    for i in want_win:
        np.testing.assert_array_equal(got_win[i], want_win[i])


# ---------------------------------------------------------------------------
# stress: concurrent clients against one started service
# ---------------------------------------------------------------------------
def test_stress_concurrent_reads_and_scans_exact(cell):
    keys, q, lb = cell
    svc = _svc(keys, "async", warm_scan_lengths=(8,))
    errs = []

    def client(t):
        try:
            rng = np.random.default_rng(t)
            for _ in range(30):
                lo = int(rng.integers(0, q.size - 64))
                n = int(rng.integers(1, 64))
                if t % 3 == 0:
                    pos, win = svc.scan(q[lo:lo + n], 8).result(60.0)
                    np.testing.assert_array_equal(pos, lb[lo:lo + n])
                    np.testing.assert_array_equal(
                        win, _scan_oracle(keys, lb[lo:lo + n], 8))
                else:
                    np.testing.assert_array_equal(
                        svc.submit(q[lo:lo + n]).result(60.0),
                        lb[lo:lo + n])
        except BaseException as e:   # noqa: BLE001 — surface in main thread
            errs.append(e)

    with svc:
        ts = [threading.Thread(target=client, args=(t,)) for t in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    assert not errs, errs
    snap = svc.metrics.snapshot()
    assert snap["cache_hit_rate"] > 0.0
    assert snap["warm_compiles"] > 0
    assert snap["p99_request_ms"] > 0.0 and snap["p99_queue_ms"] > 0.0
    assert svc._async._inflight == 0 and svc._async._ring.empty()


def test_stress_mutable_concurrent_writers_bracketed(cell):
    """Readers race two disjoint insert streams: every read is bracketed
    by LB(base) <= got <= LB(base + all inserts), every insert is
    admitted exactly once, and no future is left pending."""
    keys, q, _ = cell
    half = keys[::2].copy()
    fresh = np.setdiff1d(keys[1::2], half)[:2_000]
    lo_lb = base.lower_bound_oracle(half, q)
    hi_lb = base.lower_bound_oracle(np.union1d(half, fresh), q)
    svc = MutableLookupService(half, MutableLookupServiceConfig(
        index="pgm", hyper=dict(eps=32), max_batch=256, deadline_ms=1.0,
        executor="async", compact_threshold=768), device=CPU)
    errs, admitted = [], []

    def writer(lo):
        try:
            part = fresh[lo::2]
            futs = [svc.insert(part[i:i + 100])
                    for i in range(0, part.size, 100)]
            admitted.append(sum(int(f.result(60.0).sum()) for f in futs))
        except BaseException as e:   # noqa: BLE001
            errs.append(e)

    def reader(t):
        try:
            rng = np.random.default_rng(100 + t)
            for _ in range(25):
                lo = int(rng.integers(0, q.size - 64))
                n = int(rng.integers(1, 64))
                got = svc.submit(q[lo:lo + n]).result(60.0)
                assert np.all(lo_lb[lo:lo + n] <= got)
                assert np.all(got <= hi_lb[lo:lo + n])
        except BaseException as e:   # noqa: BLE001
            errs.append(e)

    with svc:
        ts = ([threading.Thread(target=writer, args=(w,)) for w in range(2)]
              + [threading.Thread(target=reader, args=(t,))
                 for t in range(3)])
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    assert not errs, errs
    assert sum(admitted) == fresh.size
    merged = np.union1d(half, fresh)
    np.testing.assert_array_equal(svc.lookup(q[:500]),
                                  base.lower_bound_oracle(merged, q[:500]))


def _slow(svc, bucket, delay):
    """Wrap the warmed read executable of ``bucket`` in a sleep."""
    ckey = ((svc.generation.version,), "read", 0, bucket, svc.devices[0])
    real = svc.exec_cache._exes[ckey]
    svc.exec_cache._exes[ckey] = lambda *a: (time.sleep(delay), real(*a))[1]
    return ckey, real


def test_fifo_completion_per_client(cell):
    """Completion order is admission order: in ANY snapshot, the done set
    is a prefix.  The watcher sleeps 0.1 ms between snapshots: a thread
    spinning on the GIL makes each of the many GIL hand-offs of an eager
    torch batch wait out the interpreter's switch interval."""
    keys, q, _ = cell
    svc = _svc(keys, "async", max_batch=64)
    with svc:
        _slow(svc, svc.dispatcher.padded_size(64), 0.003)
        futs = [svc.submit(q[i * 32:(i + 1) * 32]) for i in range(40)]
        deadline = time.perf_counter() + 60.0
        while not futs[-1].done():
            saw_done = False
            for f in reversed(futs):
                d = f.done()
                assert not (saw_done and not d), "per-client FIFO violated"
                saw_done = saw_done or d
            assert time.perf_counter() < deadline
            time.sleep(1e-4)
    assert all(f.done() for f in futs)


def test_double_buffering_overlaps_inflight_slots(cell):
    """With completion slow, the dispatch thread keeps launching: the
    in-flight depth exceeds one and stays within the ring's bound."""
    keys, q, lb = cell
    svc = _svc(keys, "async", max_batch=64, slots=3)
    real_complete = svc.dispatcher.complete
    svc.dispatcher.complete = (
        lambda launched: (time.sleep(0.02), real_complete(launched))[1])
    with svc:
        futs = [svc.submit(q[i * 64:(i + 1) * 64]) for i in range(12)]
        got = np.concatenate([f.result(60.0) for f in futs])
    np.testing.assert_array_equal(got, lb[:12 * 64])
    snap = svc.metrics.snapshot()
    assert snap["max_inflight_slots"] >= 2
    # ring capacity + one slot mid-completion + one launch entering it
    assert snap["max_inflight_slots"] <= 3 + 2
    assert snap["mean_inflight_slots"] > 0.0
    assert svc.health_snapshot()["inflight_saturation"] > 0.0


# ---------------------------------------------------------------------------
# drain/stop: nothing admitted is ever left unresolved
# ---------------------------------------------------------------------------
def test_inline_drain_resolves_everything_and_empties_ring(cell):
    keys, q, lb = cell
    svc = _svc(keys, "async", max_batch=64, slots=2)
    futs = [svc.submit(q[i * 64:(i + 1) * 64]) for i in range(10)]
    svc.drain()
    assert all(f.done() for f in futs)
    np.testing.assert_array_equal(
        np.concatenate([f.result(1.0) for f in futs]), lb[:640])
    assert svc._async._inflight == 0 and svc._async._ring.empty()


def test_stop_resolves_everything_admitted(cell):
    keys, q, lb = cell
    svc = _svc(keys, "async", max_batch=128)
    svc.start()
    futs = [svc.submit(q[i * 50:(i + 1) * 50]) for i in range(30)]
    svc.stop()
    assert all(f.done() for f in futs)
    np.testing.assert_array_equal(
        np.concatenate([f.result(1.0) for f in futs]), lb[:1500])
    np.testing.assert_array_equal(svc.lookup(q[:40]), lb[:40])


def test_result_timeout_orphans_nothing(cell):
    keys, q, lb = cell
    svc = _svc(keys, "async")
    fut = svc.submit(q[:64])
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.01)
    svc.drain()
    np.testing.assert_array_equal(fut.result(1.0), lb[:64])


def test_stop_with_straggler_joins_cleanly(cell):
    keys, q, lb = cell
    svc = _svc(keys, "async", max_batch=64)
    svc.start()
    _slow(svc, svc.dispatcher.padded_size(64), 0.5)
    fut = svc.submit(q[:64])
    t0 = time.perf_counter()
    svc.stop()
    assert time.perf_counter() - t0 < 30.0
    np.testing.assert_array_equal(fut.result(1.0), lb[:64])


# ---------------------------------------------------------------------------
# executable cache: hits, warm accounting, invalidation on swap
# ---------------------------------------------------------------------------
def test_cache_hits_after_warmup_no_steady_state_misses(cell):
    keys, q, _ = cell
    svc = _svc(keys, "async", max_batch=128)
    with svc:
        for f in [svc.submit(q[i * 128:(i + 1) * 128]) for i in range(8)]:
            f.result(60.0)
    snap = svc.metrics.snapshot()
    assert snap["warm_compiles"] > 0
    assert snap["cache_misses"] == 0
    assert snap["cache_hits"] >= 8
    assert snap["cache_hit_rate"] == 1.0


def test_warm_buckets_and_scan_lengths_configure_the_warm_up(cell):
    keys, q, lb = cell
    svc = _svc(keys, "async", max_batch=1024, warm_buckets=(100, 1000),
               warm_scan_lengths=(4, 8))
    assert svc._resolved_warm_buckets() == (128, 1024)
    assert svc.warm_now() == 2 * 3
    with svc.exec_cache._mu:
        cells = sorted((k[1], k[2], k[3]) for k in svc.exec_cache._exes)
    assert cells == [("read", 0, 128), ("read", 0, 1024), ("scan", 4, 128),
                     ("scan", 4, 1024), ("scan", 8, 128), ("scan", 8, 1024)]
    assert _svc(keys, "async", max_batch=1024)._resolved_warm_buckets() == \
        (128, 256, 512, 1024)
    np.testing.assert_array_equal(svc.lookup(q[:100]), lb[:100])


def test_hot_swap_invalidates_cache_and_rewarms(cell):
    keys, q, _ = cell
    svc = _svc(keys, "async", max_batch=128)
    with svc:
        svc.lookup(q[:128], timeout=60.0)
        assert len(svc.exec_cache) > 0
        new_keys = keys[::2].copy()
        gen = svc.swap_keys(new_keys)
        with svc.exec_cache._mu:
            assert all(k[0][0] == gen.version
                       for k in svc.exec_cache._exes)
        svc.warm_wait()
        hits, misses = svc.exec_cache.counters()
        for i in range(0, 384, 128):       # warmed buckets only
            np.testing.assert_array_equal(
                svc.lookup(q[i:i + 128], timeout=60.0),
                base.lower_bound_oracle(new_keys, q[i:i + 128]))
        assert svc.exec_cache.counters() == (hits + 3, misses)
    assert len(svc.exec_cache) > 0


def test_hot_swap_races_inflight_slot_old_generation_wins(cell):
    keys, q, lb = cell
    svc = _svc(keys, "async")
    fut = svc.submit(q[:100])
    svc._async._drain_launches()        # launched against the OLD plan
    new_keys = keys[::4].copy()
    svc.swap_keys(new_keys)             # swap while the slot is in flight
    svc._async._complete_ring_inline()
    np.testing.assert_array_equal(fut.result(1.0), lb[:100])   # old gen
    lb_new = base.lower_bound_oracle(new_keys, q[:100])
    np.testing.assert_array_equal(svc.lookup(q[:100], timeout=60.0), lb_new)


def test_executable_cache_unit_semantics():
    cache = ExecutableCache()
    ctx = type("C", (), {})()
    ctx.key, ctx.bind, ctx.instrumented = (7,), (), False
    disp = __import__("torch").device("cpu")    # the executables' device
    fn = lambda q: q                # noqa: E731 — a plain callable
    assert cache.get(ctx, "read", 0, 128, lambda: fn, disp, warm=True) is fn
    assert cache.counters() == (0, 0)       # warm never counts hit/miss
    assert cache.warm_compiles == 1
    assert cache.get(ctx, "read", 0, 128, lambda: fn, disp) is fn
    assert cache.counters() == (1, 0)
    cache.get(ctx, "read", 0, 256, lambda: fn, disp)
    assert cache.counters() == (1, 1)
    ctx2 = type("C", (), {})()
    ctx2.key, ctx2.bind, ctx2.instrumented = (8,), (), False
    cache.get(ctx2, "read", 0, 128, lambda: fn, disp)
    assert len(cache) == 3
    assert cache.invalidate(keep_version=8) == 2
    assert len(cache) == 1
    assert cache.invalidate() == 1
    assert cache.hit_rate == pytest.approx(1 / 3)
    # a plan's callable on the CPU is not captured either
    plan_fn = lambda q: q           # noqa: E731
    plan_fn.lookup_plan = object()
    assert cache.get(ctx, "read", 0, 512, lambda: plan_fn, disp) is plan_fn
    assert cache.graph_stats() == {"graphs_built": 0, "graph_replays": 0,
                                   "warm_replays": 0, "kernel_launches": {}}


def test_async_executor_requires_double_buffering():
    with pytest.raises(ValueError, match="slots"):
        AsyncExecutor(service=None, slots=1)
    with pytest.raises(ValueError, match="executor"):
        LookupService(np.arange(1, 100, dtype=np.uint64),
                      LookupServiceConfig(executor="turbo"), device=CPU)


def test_an_unknown_context_fails_only_its_own_batch(cell):
    """A context that is neither an `AsyncContext` nor a `RoutedContext`
    fails its own batch with a TypeError; the batches around it are
    served."""
    keys, q, lb = cell
    svc = _svc(keys, "async")
    before = svc.submit(q[:5])
    svc._async._launch_item(WorkItem(kind="read",
                                     group=svc.batcher.take(force=True),
                                     ctx=svc._async_context()))
    fut = svc.submit(q[:8])
    batch = svc.batcher.take(force=True)
    svc._async._launch_item(WorkItem(kind="read", group=batch,
                                     ctx=object()))
    svc._async._complete_ring_inline()
    with pytest.raises(TypeError, match="object context"):
        fut.result(1.0)
    np.testing.assert_array_equal(before.result(1.0), lb[:5])
    np.testing.assert_array_equal(svc.lookup(q[:8]), lb[:8])


# ---------------------------------------------------------------------------
# fault injection: failures are request-scoped, never engine-scoped
# ---------------------------------------------------------------------------
class Boom(RuntimeError):
    pass


def test_launch_failure_fails_only_that_batch(cell):
    keys, q, lb = cell
    svc = _svc(keys, "async", max_batch=64)
    with svc:
        boom = Boom("resolution exploded")
        real_get = svc.exec_cache.get
        fired = threading.Event()

        def poisoned(ctx, kind, aux, bucket, make_fn, dispatcher,
                     warm=False):
            if not warm and not fired.is_set():
                fired.set()
                raise boom
            return real_get(ctx, kind, aux, bucket, make_fn, dispatcher,
                            warm=warm)

        svc.exec_cache.get = poisoned
        bad = svc.submit(q[:64])
        with pytest.raises(Boom) as ei:
            bad.result(60.0)
        assert ei.value is boom
        good = svc.submit(q[64:128])
        np.testing.assert_array_equal(good.result(60.0), lb[64:128])
    assert svc._async._inflight == 0 and svc._async._ring.empty()


def test_completion_failure_fails_only_that_slot(cell):
    keys, q, lb = cell
    svc = _svc(keys, "async", max_batch=64)
    with svc:
        ckey = ((svc.generation.version,), "read", 0,
                svc.dispatcher.padded_size(64), svc.devices[0])
        real = svc.exec_cache._exes[ckey]
        svc.exec_cache._exes[ckey] = lambda *a: None   # completion chokes
        bad = svc.submit(q[:64])
        with pytest.raises(BaseException):
            bad.result(60.0)
        svc.exec_cache._exes[ckey] = real
        good = svc.submit(q[:64])
        np.testing.assert_array_equal(good.result(60.0), lb[:64])


def test_insert_failure_fails_only_that_run(cell):
    keys, q, _ = cell
    half = keys[::2].copy()
    lb_half = base.lower_bound_oracle(half, q[:64])
    svc = MutableLookupService(half, MutableLookupServiceConfig(
        index="pgm", hyper=dict(eps=32), max_batch=128, deadline_ms=1.0,
        executor="async", auto_compact=False), device=CPU)
    fresh = np.setdiff1d(keys[1::2], half)[:50]
    with svc:
        boom = Boom("delta exploded")
        real_insert = svc.mindex.insert
        fired = threading.Event()

        def poisoned(ks):
            if not fired.is_set():
                fired.set()
                raise boom
            return real_insert(ks)

        svc.mindex.insert = poisoned
        r0 = svc.submit(q[:64])
        bad = svc.insert(fresh)
        r1 = svc.submit(q[:64])
        np.testing.assert_array_equal(r0.result(60.0), lb_half)
        with pytest.raises(Boom) as ei:
            bad.result(60.0)
        assert ei.value is boom
        np.testing.assert_array_equal(r1.result(60.0), lb_half)
        assert int(svc.insert(fresh).result(60.0).sum()) == fresh.size
    merged = np.union1d(half, fresh)
    np.testing.assert_array_equal(
        svc.lookup(q[:64]), base.lower_bound_oracle(merged, q[:64]))
