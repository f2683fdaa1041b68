"""The port's mutable layer against the reference's and the replay oracle.

`DeltaBuffer` (the ``INT64_MAX`` pad of the port's key codec in place of
``UINT64_MAX``), the mutable-index invariant on the 4 surrogates x every
LB index (the port's `MutableIndex` against the naive oracle at every
op, and against the reference's `MutableIndex` op for op, compactions
forced), compaction racing inserts and resets, the ``2^64 - 1`` key, the
mutable service on both executors (`replay_on_service` with scans
against `oracle_scan_replay` and the reference's service), and the fast
oracle `chip_smoke.py` holds its 200M-key traces against.
"""
import jax

jax.config.update("jax_enable_x64", True)

import importlib.util
import os
import threading

import numpy as np
import pytest

from repro import mutable as rmutable
from repro.serve.lookup import MutableLookupService as RMutableService
from repro.serve.lookup import \
    MutableLookupServiceConfig as RMutableServiceConfig
from repro.workloads import make_workload as rmake_workload
from repro_torch.core import base
from repro_torch.core import spec as core_spec
from repro_torch.data import sosd
from repro_torch.kernels.common import decode_keys
from repro_torch.mutable import (LB_INDEXES, UINT64_MAX, DeltaBuffer,
                                 MutableIndex)
from repro_torch.mutable.index import make_merged_fn
from repro_torch.serve.lookup import (MutableLookupService,
                                      MutableLookupServiceConfig)
from repro_torch.workloads import (OP_INSERT, Workload, make_workload,
                                   oracle_replay, oracle_scan_replay,
                                   replay_on_service)

CPU = "cpu"
INT64_MAX = np.iinfo(np.int64).max


def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# delta buffer
# ---------------------------------------------------------------------------
def test_delta_buffer_dedup_and_merge_match_reference():
    base_np = np.array([10, 20, 30], np.uint64)
    ins = [np.array([20, 5, 5, 40], np.uint64), np.array([5], np.uint64),
           np.array([25, 2 ** 64 - 1, 25], np.uint64)]
    d, rd = DeltaBuffer.empty(device=CPU), rmutable.DeltaBuffer.empty()
    assert d.count == 0 and int(d.device.shape[0]) == 128
    snaps = []
    for k in ins:
        d2, adm = d.with_inserted(base_np, k)
        rd, radm = rd.with_inserted(base_np, k)
        np.testing.assert_array_equal(adm, radm)
        np.testing.assert_array_equal(d2.keys_np, rd.keys_np)
        np.testing.assert_array_equal(decode_keys(d2.device),
                                      np.asarray(rd.device))
        if not adm.any():
            assert d2 is d                          # no-op reuses snapshot
        snaps.append((d2, rd))
        d = d2
    np.testing.assert_array_equal(d.keys_np, [5, 25, 40, 2 ** 64 - 1])
    left = d.minus(snaps[0][0])
    np.testing.assert_array_equal(left.keys_np,
                                  rd.minus(snaps[0][1]).keys_np)
    np.testing.assert_array_equal(left.keys_np, [25, 2 ** 64 - 1])
    assert d.minus(DeltaBuffer.empty(device=CPU)) is d


def test_delta_buffer_pad_growth_and_sentinel():
    d, adm = DeltaBuffer.empty(device=CPU).with_inserted(
        np.array([1], np.uint64), np.arange(2, 202, dtype=np.uint64))
    assert adm.sum() == 200 and d.count == 200
    assert int(d.device.shape[0]) == 256               # next pow2 bucket
    enc = d.device.numpy()
    assert (enc[200:] == INT64_MAX).all()              # the encoded pad
    assert (decode_keys(d.device)[200:] == UINT64_MAX).all()
    assert (np.diff(enc[:200]) > 0).all()


# ---------------------------------------------------------------------------
# the mutable-index invariant: every LB index x surrogate, against the
# naive oracle at every op and the reference op for op
# ---------------------------------------------------------------------------
HYPER = {"rmi": dict(branching=128), "pgm": dict(eps=32),
         "radix_spline": dict(eps=16, radix_bits=10)}


def _replay_both(mi, rmi_, keys, wl, compact_at=()):
    arr = np.asarray(keys, np.uint64).copy()
    for i in range(wl.n_ops):
        k = np.array([wl.keys[i]], np.uint64)
        if wl.ops[i] == OP_INSERT:
            admitted = int(mi.insert(k)[0])
            assert admitted == int(rmi_.insert(k)[0]), f"op {i}"
            p = int(np.searchsorted(arr, k[0]))
            fresh = not (p < arr.size and arr[p] == k[0])
            assert admitted == int(fresh), f"op {i}: admit flag"
            if fresh:
                arr = np.insert(arr, p, k[0])
        else:
            pos = int(mi.lookup(k)[0])
            assert pos == int(np.searchsorted(arr, k[0])), f"op {i}"
            assert pos == int(rmi_.lookup(k)[0]), f"op {i} vs reference"
        if i in compact_at:
            mi.compact()
            rmi_.compact()
    return arr


@pytest.mark.parametrize("index", LB_INDEXES)
@pytest.mark.parametrize("dataset", sorted(sosd.DATASETS))
def test_mutable_invariant_every_index_and_dataset(index, dataset):
    assert LB_INDEXES == rmutable.LB_INDEXES
    keys = sosd.generate(dataset, 2_500, seed=5)
    hyper = HYPER.get(index, {})
    mi = MutableIndex(keys, index=index, hyper=hyper,
                      compact_threshold=1 << 30, device=CPU)
    rmi_ = rmutable.MutableIndex(keys, index=index, hyper=hyper,
                                 compact_threshold=1 << 30)
    wl = make_workload(keys, 120, mix="ycsb_a", dist="zipfian", seed=17,
                       present_frac=0.8)
    final = _replay_both(mi, rmi_, keys, wl, compact_at={40, 90})
    assert mi.view().n_keys == final.size == rmi_.view().n_keys
    gen = mi.compact()
    assert gen is not None and mi.delta_count == 0
    np.testing.assert_array_equal(mi.view().base_np, final)
    assert mi.compact() is None                    # empty delta


def test_mutable_index_uint64_max_key():
    keys = np.arange(10, 5_010, dtype=np.uint64)
    mi = MutableIndex(keys, index="rmi", hyper=dict(branching=64),
                      compact_threshold=1 << 30, device=CPU)
    rmi_ = rmutable.MutableIndex(keys, index="rmi", hyper=dict(branching=64),
                                 compact_threshold=1 << 30)
    top = np.array([UINT64_MAX], np.uint64)
    assert mi.insert(top)[0] == 1 == rmi_.insert(top)[0]
    # the real key encodes to the pad sentinel and still counts right
    assert int(mi.view().delta.device[0]) == INT64_MAX
    assert int(mi.lookup(top)[0]) == len(keys) == int(rmi_.lookup(top)[0])
    assert mi.insert(top)[0] == 0                  # still deduped
    below = np.array([UINT64_MAX - np.uint64(1)], np.uint64)
    assert int(mi.lookup(below)[0]) == len(keys)
    mi.compact()
    assert mi.view().base_np[-1] == UINT64_MAX
    assert int(mi.lookup(top)[0]) == len(keys)
    assert mi.view().n_keys == len(keys) + 1


def _slow_builder(name, in_build, release):
    real_build = base.REGISTRY["rmi"]

    @base.register(name)
    def slow_build(k, device=None, **h):
        in_build.set()
        assert release.wait(10.0)
        return real_build(k, device=device, **h)

    core_spec.register_schema(name, fields=core_spec.SCHEMAS["rmi"].fields,
                              ladder=[dict()])


def test_compaction_preserves_inserts_admitted_mid_rebuild():
    keys = sosd.generate("wiki", 4_000, seed=3)
    mi = MutableIndex(keys, index="rmi", hyper=dict(branching=128),
                      compact_threshold=1 << 30, device=CPU)
    gap = int(np.flatnonzero(np.diff(keys) > 2)[0])
    first = np.array([keys[gap] + 1], np.uint64)
    assert mi.insert(first)[0] == 1
    in_build, release = threading.Event(), threading.Event()
    _slow_builder("_torch_slow_rmi2", in_build, release)
    try:
        mi.spec = mi.spec.replace(index="_torch_slow_rmi2")
        t = threading.Thread(target=mi.compact)
        t.start()
        assert in_build.wait(10.0)
        late = np.array([keys[gap] + 2], np.uint64)  # admitted mid-rebuild
        assert mi.insert(late)[0] == 1
        release.set()
        t.join(timeout=30.0)
    finally:
        release.set()
        base.REGISTRY.pop("_torch_slow_rmi2", None)
        core_spec.SCHEMAS.pop("_torch_slow_rmi2", None)
        mi.spec = mi.spec.replace(index="rmi")
    assert mi.delta_count == 1
    np.testing.assert_array_equal(mi.view().delta.keys_np, late)
    assert first[0] in mi.view().base_np
    q = np.sort(np.concatenate([first, late]))
    merged = np.sort(np.concatenate([keys, q]))
    np.testing.assert_array_equal(mi.lookup(q), np.searchsorted(merged, q))


def test_reset_during_compaction_discards_stale_rebuild():
    old_keys = sosd.generate("amzn", 3_000, seed=1)
    new_keys = sosd.generate("osm", 2_000, seed=2)
    mi = MutableIndex(old_keys, index="rmi", hyper=dict(branching=128),
                      compact_threshold=1 << 30, device=CPU)
    mi.insert(np.array([old_keys[0] + 1], np.uint64))
    in_build, release = threading.Event(), threading.Event()
    _slow_builder("_torch_slow_rmi3", in_build, release)
    results = []
    try:
        mi.spec = mi.spec.replace(index="_torch_slow_rmi3")
        t = threading.Thread(target=lambda: results.append(mi.compact()))
        t.start()
        assert in_build.wait(10.0)
        mi.spec = mi.spec.replace(index="rmi")
        mi.reset(new_keys)
        release.set()
        t.join(timeout=30.0)
    finally:
        release.set()
        base.REGISTRY.pop("_torch_slow_rmi3", None)
        core_spec.SCHEMAS.pop("_torch_slow_rmi3", None)
    assert results == [None]
    np.testing.assert_array_equal(mi.view().base_np, new_keys)
    assert mi.delta_count == 0
    q = new_keys[::97]
    np.testing.assert_array_equal(mi.lookup(q), np.searchsorted(new_keys, q))


def test_republish_keeps_the_delta_and_merged_fn_is_the_plans():
    keys = sosd.generate("osm", 3_000, seed=4)
    mi = MutableIndex(keys, index="pgm", hyper=dict(eps=32), device=CPU)
    fresh = np.setdiff1d(keys[:-1] + 1, keys)[:10]
    mi.insert(fresh)
    v = mi.view()
    assert v.merged_fn is make_merged_fn(v.generation.plan, "torch")
    gen = mi.republish(core_spec.IndexSpec("rmi", {"branching": 64}))
    assert gen is not None and mi.index == "rmi" and mi.delta_count == 10
    merged = np.union1d(keys, fresh)
    q = merged[::7]
    np.testing.assert_array_equal(mi.lookup(q), np.searchsorted(merged, q))


# ---------------------------------------------------------------------------
# the mutable service on both executors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("executor", ["sync", "async"])
def test_replay_on_service_with_scans_matches_oracle_and_reference(executor):
    keys = sosd.generate("amzn", 8_000, seed=8)
    wl = make_workload(keys, 700,
                       mix={"read": 0.45, "insert": 0.3, "range": 0.25},
                       seed=3, range_len=8)
    want, want_win = oracle_scan_replay(keys, wl)
    cfg = dict(index="pgm", hyper=dict(eps=32), max_batch=256,
               deadline_ms=1.0, compact_threshold=150,
               warm_scan_lengths=(8,))
    svc = MutableLookupService(keys, MutableLookupServiceConfig(
        executor=executor, **cfg), device=CPU)
    with svc:
        got, got_win = replay_on_service(wl, svc, chunk=32,
                                         compact_every=250, scan_ranges=True)
    np.testing.assert_array_equal(got, want)
    assert set(got_win) == set(want_win)
    for i in want_win:
        np.testing.assert_array_equal(got_win[i], want_win[i])
    assert svc.metrics.snapshot()["compactions"] >= 1
    rsvc = RMutableService(keys, RMutableServiceConfig(**cfg))
    rwl = rmake_workload(keys, 700,
                         mix={"read": 0.45, "insert": 0.3, "range": 0.25},
                         seed=3, range_len=8)
    from repro.workloads import replay_on_service as rreplay
    rgot, rwin = rreplay(rwl, rsvc, chunk=32, compact_every=250,
                         scan_ranges=True)
    rsvc.stop()
    np.testing.assert_array_equal(got, rgot)
    for i in rwin:
        np.testing.assert_array_equal(got_win[i], rwin[i])


@pytest.mark.parametrize("mix,dist", [
    ("ycsb_b", "zipfian"), ("ycsb_e", "zipfian"), ("ycsb_a", "hot_set"),
    ({"read": 0.4, "insert": 0.4, "range": 0.2}, "sequential")])
def test_fast_oracle_equals_oracle_scan_replay(mix, dist):
    cs = _chip_smoke()
    keys = sosd.generate("wiki", 6_000, seed=2)
    keys = np.concatenate([keys, np.array([UINT64_MAX], np.uint64)])
    wl = make_workload(keys, 2_000, mix=mix, dist=dist, seed=9,
                       range_len=16, present_frac=0.7)
    # a re-insert of a present key, a repeat within a run, and 2^64 - 1
    wl.keys[:3] = [keys[5], keys[5], UINT64_MAX]
    wl.ops[:3] = OP_INSERT
    want, want_win = oracle_scan_replay(keys, wl)
    got, got_win = cs.fast_mutable_oracle(keys, wl)
    np.testing.assert_array_equal(got, want)
    assert set(got_win) == set(want_win)
    for i in want_win:
        np.testing.assert_array_equal(got_win[i], want_win[i])


@pytest.mark.parametrize("executor", ["sync", "async"])
def test_service_failing_compaction_is_observable(executor):
    keys = sosd.generate("amzn", 4_000, seed=9)
    svc = MutableLookupService(keys, MutableLookupServiceConfig(
        index="rmi", hyper=dict(branching=128), compact_threshold=8,
        auto_compact=True, executor=executor), device=CPU)
    boom = RuntimeError("rebuild exploded")

    def failing_compact():
        raise boom

    svc.mindex.compact = failing_compact
    svc.insert(np.arange(1, 33, dtype=np.uint64) * 2 + keys[0])
    svc.drain()
    t = svc._compact_thread
    assert t is not None
    t.join(timeout=10.0)
    assert svc.metrics.snapshot()["compaction_failures"] >= 1
    assert svc.last_compaction_error is boom
    svc.insert(np.arange(1, 9, dtype=np.uint64) * 3 + keys[0])
    svc.drain()
    assert svc._compact_thread is t                # backoff: no respawn
    with pytest.raises(RuntimeError, match="rebuild exploded"):
        svc.force_compact()
    assert svc.metrics.snapshot()["compaction_failures"] >= 2
    svc.stop()


@pytest.mark.parametrize("executor", ["sync", "async"])
def test_service_inflight_batches_across_forced_compaction(executor):
    keys = sosd.generate("osm", 6_000, seed=4)
    svc = MutableLookupService(keys, MutableLookupServiceConfig(
        index="pgm", hyper=dict(eps=32), max_batch=256, deadline_ms=60_000.0,
        compact_threshold=1 << 30, auto_compact=False, executor=executor),
        device=CPU)
    wl = make_workload(keys, 500, mix="ycsb_a", dist="hot_set", seed=21,
                       present_frac=0.85)
    head, tail = 200, 500
    futs = []
    i = 0
    while i < head:
        j = min(i + 37, head)
        op = wl.ops[i]
        j = next((k for k in range(i, j) if wl.ops[k] != op), j)
        ks = wl.keys[i:j]
        futs.append(svc.insert(ks) if op == OP_INSERT else svc.submit(ks))
        i = j
    svc.drain()
    assert svc.mindex.delta_count > 0
    while i < tail:
        j = i
        while j < tail and wl.ops[j] == wl.ops[i] and j - i < 41:
            j += 1
        ks = wl.keys[i:j]
        futs.append(svc.insert(ks) if wl.ops[i] == OP_INSERT
                    else svc.submit(ks))
        i = j
    assert svc.batcher.pending_requests > 0        # genuinely in flight
    assert svc.force_compact() is not None
    svc.drain()
    got = np.concatenate([f.result(30.0) for f in futs])
    expected = oracle_replay(keys, Workload(ops=wl.ops[:tail],
                                            keys=wl.keys[:tail],
                                            aux=wl.aux[:tail]))
    np.testing.assert_array_equal(got, expected)
    assert svc.metrics.snapshot()["compactions"] >= 1
    svc.stop()


@pytest.mark.parametrize("executor", ["sync", "async"])
def test_service_auto_compaction_under_background_flusher(executor):
    keys = sosd.generate("face", 8_000, seed=6)
    svc = MutableLookupService(keys, MutableLookupServiceConfig(
        index="rmi", hyper=dict(branching=256), max_batch=128,
        deadline_ms=1.0, compact_threshold=60, executor=executor),
        device=CPU)
    wl = make_workload(keys, 700, mix="ycsb_a", dist="zipfian", seed=23,
                       present_frac=0.9)
    with svc:
        got = replay_on_service(wl, svc, chunk=32)
    np.testing.assert_array_equal(got, oracle_replay(keys, wl))
    snap = svc.metrics.snapshot()
    assert snap["compactions"] >= 1
    assert snap["insert_batches"] >= 1
    assert snap["admitted"] == int(got[wl.ops == OP_INSERT].sum())
    assert svc.generation.version >= 1


def test_service_range_blend_and_delta_gauge():
    keys = sosd.generate("amzn", 5_000, seed=8)
    svc = MutableLookupService(keys, MutableLookupServiceConfig(
        index="radix_spline", hyper=dict(eps=16, radix_bits=10),
        max_batch=256, deadline_ms=1.0, compact_threshold=1 << 30),
        device=CPU)
    wl = make_workload(keys, 300, mix="ycsb_e", dist="sequential", seed=2)
    got = replay_on_service(wl, svc, chunk=64)
    np.testing.assert_array_equal(got, oracle_replay(keys, wl))
    snap = svc.metrics.snapshot()
    assert snap["delta_keys"] == svc.mindex.delta_count > 0
    assert 0.0 <= snap["delta_occupancy"] < 1e-3
    assert svc.health_snapshot()["delta_keys"] == svc.mindex.delta_count
    svc.stop()


def test_mutable_service_refuses_a_routed_topology():
    keys = np.arange(1, 1_001, dtype=np.uint64)
    with pytest.raises(ValueError, match="routed"):
        MutableLookupService(keys, MutableLookupServiceConfig(shards=2),
                             device=CPU)


def test_traced_mutable_service_records_insert_and_compaction_spans():
    keys = sosd.generate("wiki", 20_000, seed=9)
    svc = MutableLookupService(keys, MutableLookupServiceConfig(
        index="rmi", hyper=dict(branching=256), max_batch=512,
        deadline_ms=1.0, compact_threshold=1_000, auto_compact=False,
        trace=True, executor="async"), device=CPU)
    new_keys = (np.asarray(keys[:1500], dtype=np.uint64) + 1).astype(
        np.uint64)
    with svc:
        svc.insert(new_keys).result(timeout=60.0)
        svc.submit(keys[:64]).result(timeout=60.0)
        svc.force_compact()
    by_name = {}
    for s in svc.recorder.spans():
        by_name.setdefault(s.name, []).append(s)
    assert {"insert", "read"} <= {s.args["kind"] for s in by_name["request"]}
    assert by_name["compaction"][0].cat == "lifecycle"
    assert "index_build" in by_name and "publish" in by_name
    assert "launch" in by_name and "warmup" in by_name
