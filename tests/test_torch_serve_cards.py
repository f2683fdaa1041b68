"""Lookup serving over several devices: the data axis and routed lanes.

The port's counterpart of the reference's data-mesh dispatch
(`repro.serve.lookup.dispatch.ShardedDispatcher` over `data_axis_mesh`)
and of its per-device routed lanes, held on the CPU over lists of
repeated CPU devices: ``padded_size`` equal to the reference's for one
to five devices; a broadcast over k = 1..4 lanes on both executors (read,
scan, instrumented read; RMI and PGM) bit-identical to the one-device
port, to the reference's single-device ``jnp`` plan and to
``np.searchsorted``, with the one-device health record; routed 2 x 2
lanes over four devices equal to the reference's routed service; a
mutable service over two lanes that sees an insert on both; and no
fallback: no card and no device raises, a missing card raises, and a
lane that fails fails its batch.  The same paths over real cards are in
`tests/test_torch_cuda.py`.
"""
import jax

jax.config.update("jax_enable_x64", True)

import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as rplan
from repro.core import spec as rspec
from repro.serve.lookup import LookupService as RLookupService
from repro.serve.lookup import LookupServiceConfig as RLookupServiceConfig
from repro.serve.lookup.dispatch import ShardedDispatcher as RDispatcher
from repro_torch.core import plan as plan_mod
from repro_torch.core import spec
from repro_torch.data import sosd
from repro_torch.kernels.common import encode_keys
from repro_torch.obs.health import fold_stats
from repro_torch.serve.lookup import (IndexRegistry, LookupService,
                                      LookupServiceConfig,
                                      MutableLookupService,
                                      MutableLookupServiceConfig,
                                      RoutedDispatcher, ShardedDispatcher)
from repro_torch.serve.lookup.dispatch import (data_axis_devices,
                                               serving_devices)

CPU = "cpu"
N_KEYS = 3_000
SCAN_M = 4
HEALTH_FIELDS = ("n", "disp_sum", "disp_max", "width_sum", "steps_sum")
INDEXES = {"rmi": {"branching": 64}, "pgm": {"eps": 16}}


@functools.lru_cache(maxsize=None)
def _cell():
    keys = sosd.generate("amzn", N_KEYS, seed=3)
    q = sosd.make_queries(keys, 1_500, seed=4, present_frac=0.5)
    return keys, q


def _requests(q):
    """Read requests of 1..37 keys: batches of every size, pads in every
    slice position."""
    out, i, size = [], 0, 1
    while i < q.size:
        out.append(q[i:i + size])
        i += size
        size = size % 37 + 1
    return out


@functools.lru_cache(maxsize=None)
def _reference(index):
    """The reference's single-device ``jnp`` plan: positions and scan
    windows over the cell's queries."""
    keys, q = _cell()
    b = rspec.build(rspec.IndexSpec(index, dict(INDEXES[index])), keys)
    p = rplan.lower(b, jnp.asarray(keys))
    qj = jnp.asarray(q)
    pos = np.asarray(p.compile(backend="jnp")(qj))
    spos, win = p.compile_scan(SCAN_M, backend="jnp")(qj[:300])
    return pos, (np.asarray(spos), np.asarray(win))


def _serve(keys, q, index, executor, **kw):
    """Reads, scans and the health record of one service."""
    svc = LookupService(keys, LookupServiceConfig(
        spec=spec.IndexSpec(index, dict(INDEXES[index])), executor=executor,
        max_batch=256, deadline_ms=0.0), **kw)
    try:
        futs = [svc.submit(r) for r in _requests(q)]
        scans = [svc.scan(q[i:i + 30], SCAN_M) for i in range(0, 300, 30)]
        svc.drain()
        pos = np.concatenate([f.result(10.0) for f in futs])
        got = [f.result(10.0) for f in scans]
        scan = (np.concatenate([g[0] for g in got]),
                np.concatenate([g[1] for g in got]))
        return pos, scan, svc.health.current()
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# the data axis
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_padded_size_matches_reference(n):
    ref = RDispatcher()
    ref.n_shards = n                     # the reference's arithmetic at n
    port = ShardedDispatcher(devices=[CPU] * n)
    assert port.n_shards == n
    for m in [1, 2, 3, 100, 127, 128, 129, 255, 256, 257, 1000, 4096, 4097,
              10_000]:
        p = port.padded_size(m)
        assert p == ref.padded_size(m), m
        assert p % n == 0 and p >= m
        valid = port.slice_valid(m, p)
        assert sum(valid) == m and len(valid) == n
        assert valid == sorted(valid, reverse=True)


@pytest.mark.parametrize("index", sorted(INDEXES))
@pytest.mark.parametrize("executor", ["sync", "async"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_broadcast_over_k_lanes_is_the_one_device_answer(index, executor, k):
    keys, q = _cell()
    one = _serve(keys, q, index, executor, device=CPU)
    got = _serve(keys, q, index, executor, devices=[CPU] * k)
    ref_pos, ref_scan = _reference(index)
    lb = np.searchsorted(keys, q)
    for pos, scan, _ in (one, got):
        np.testing.assert_array_equal(pos, lb)
        np.testing.assert_array_equal(pos, ref_pos)
        np.testing.assert_array_equal(scan[0], ref_scan[0])
        np.testing.assert_array_equal(scan[1], ref_scan[1])
    rec1, reck = one[2], got[2]
    assert rec1.n == q.size
    for f in HEALTH_FIELDS:
        assert getattr(reck, f) == getattr(rec1, f), f
    np.testing.assert_array_equal(reck.disp_hist, rec1.disp_hist)
    np.testing.assert_array_equal(reck.traffic_total, rec1.traffic_total)


@pytest.mark.parametrize("k", [2, 3])
def test_split_instrumented_read_folds_to_the_reference_stats(k):
    """One padded batch split over k lanes: each slice counts only its
    own real keys, and the folded stats vector is the reference's
    instrumented plan's over the whole padded batch."""
    keys, q = _cell()
    q = q[:333]
    sp = spec.IndexSpec("rmi", dict(INDEXES["rmi"]))
    p = plan_mod.lower(spec.build(sp, keys, device=CPU),
                       encode_keys(keys, CPU))
    d = ShardedDispatcher(devices=[CPU] * k)
    pos, stats = d(p.compile_instrumented(), q, n_valid_arg=True)
    rb = rspec.build(rspec.IndexSpec("rmi", dict(INDEXES["rmi"])), keys)
    rp = rplan.lower(rb, jnp.asarray(keys))
    padded = np.concatenate([q, np.full(d.padded_size(q.size) - q.size,
                                        q[0], np.uint64)])
    rpos, rstats = rp.compile_instrumented(backend="jnp")(
        jnp.asarray(padded), np.int32(q.size))
    np.testing.assert_array_equal(pos, np.asarray(rpos)[:q.size])
    np.testing.assert_array_equal(stats, np.asarray(rstats))
    assert stats[0] == q.size


def test_fold_stats_adds_and_takes_the_max():
    a = np.arange(93, dtype=np.int64)
    b = np.arange(93, dtype=np.int64)[::-1].copy()
    out = fold_stats([a, b])
    assert out[2] == max(a[2], b[2])
    np.testing.assert_array_equal(np.delete(out, 2),
                                  np.delete(a + b, 2))


def test_plan_placed_on_another_device_copies_state_not_callables():
    """`LookupPlan.to`: the bounds state, the keys and the fused
    executor's derived state are copied, the cached callables are not;
    a generation placed nowhere else has no replica there."""
    keys, _ = _cell()
    reg = IndexRegistry(device=CPU)
    gen = reg.build_and_publish(spec.IndexSpec("rmi", {"branching": 64},
                                               backend="cuda"), keys)
    assert "_rmi_f32_state" in gen.plan._cache
    assert gen.plan.to(CPU) is gen.plan and gen.on(CPU) is gen
    meta = gen.plan.to("meta")
    assert meta.data.device.type == "meta"
    assert all(t.device.type == "meta"
               for t in meta.bounds.state.values())
    assert meta._cache["_rmi_f32_state"].a2.device.type == "meta"
    assert not any(isinstance(k, tuple) for k in meta._cache)
    with pytest.raises(KeyError, match="no replica"):
        gen.on("meta")


# ---------------------------------------------------------------------------
# routed lanes and the mutable service over several devices
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _reference_routed(executor):
    keys, q = _cell()
    svc = RLookupService(keys, RLookupServiceConfig(
        spec=rspec.IndexSpec("rmi", dict(INDEXES["rmi"])), max_batch=256,
        deadline_ms=0.0, executor=executor, shards=2, replicas=2))
    try:
        return svc.lookup(q)
    finally:
        svc.stop()


@pytest.mark.parametrize("executor", ["sync", "async"])
def test_routed_lanes_over_four_devices_match_reference(executor):
    keys, q = _cell()
    svc = LookupService(keys, LookupServiceConfig(
        spec=spec.IndexSpec("rmi", dict(INDEXES["rmi"])), max_batch=256,
        deadline_ms=0.0, executor=executor, shards=2, replicas=2),
        devices=[CPU] * 4)
    try:
        assert isinstance(svc.dispatcher, RoutedDispatcher)
        assert [len(g) for g in svc.dispatcher.lanes] == [2, 2]
        got = np.concatenate([svc.lookup(q[i:i + 200])
                              for i in range(0, q.size, 200)])
        np.testing.assert_array_equal(got, np.searchsorted(keys, q))
        np.testing.assert_array_equal(got, _reference_routed(executor))
        touched = {r["shard"] for r in svc.metrics.per_shard()}
        assert touched == {0, 1}
    finally:
        svc.stop()


@pytest.mark.parametrize("executor", ["sync", "async"])
def test_mutable_service_over_two_lanes_sees_an_insert_on_both(executor):
    keys, q = _cell()
    svc = MutableLookupService(keys, MutableLookupServiceConfig(
        index="pgm", hyper=dict(INDEXES["pgm"]), executor=executor,
        deadline_ms=0.0, auto_compact=False), devices=[CPU, CPU])
    try:
        low = np.arange(1, 41, dtype=np.uint64) + keys[0]
        fresh = np.setdiff1d(low, keys)
        ins = svc.insert(fresh)
        read = svc.submit(q[:400])          # admitted after the insert
        svc.drain()
        assert ins.result(5.0).sum() == fresh.size
        merged = np.union1d(keys, fresh)
        got = read.result(5.0)
        np.testing.assert_array_equal(got, np.searchsorted(merged, q[:400]))
        # both slices of the batch answered over the delta
        base = np.searchsorted(keys, q[:400])
        assert (got[:200] != base[:200]).any()
        assert (got[200:] != base[200:]).any()
        gen = svc.force_compact()
        assert gen is not None and svc.mindex.delta_count == 0
        np.testing.assert_array_equal(svc.lookup(q[:400]),
                                      np.searchsorted(merged, q[:400]))
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------
@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_no_card_and_no_device_raises(no_card):
    keys, _ = _cell()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data_axis_devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LookupService(keys)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MutableLookupService(keys)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LookupService(keys, devices=[CPU, "cuda:1"])
    with pytest.raises(ValueError, match="device or devices"):
        serving_devices(CPU, [CPU])
    with pytest.raises(ValueError, match="at least one"):
        serving_devices(devices=[])


class Boom(RuntimeError):
    pass


def test_a_failed_lane_fails_its_batch():
    """No other device answers for a lane that fails: the synchronous
    split and the launch half both raise, and the dispatcher serves the
    next batch."""
    keys, q = _cell()

    def boom(q):
        raise Boom("lane 1")

    def ok(q):
        return q

    d = ShardedDispatcher(devices=[CPU, CPU])
    with pytest.raises(Boom):
        d((ok, boom), q[:100])
    with pytest.raises(Boom):
        d.launch((ok, boom), q[:100], ((), ()), ({}, {}))
    got = d((ok, ok), q[:100])
    np.testing.assert_array_equal(got, encode_keys(q[:100], CPU).numpy())


def test_serve_lookup_example_runs_on_the_cpu(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trace = tmp_path / "trace.json"
    out = subprocess.run(
        [sys.executable, os.path.join(root, "examples",
                                      "torch_serve_lookup.py"),
         "--device", "cpu", "--n-keys", "20000",
         "--requests-per-client", "10", "--trace-out", str(trace)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")))
    assert out.returncode == 0, out.stderr
    assert "hot-swapped amzn -> wiki" in out.stdout
    assert "wrong answers: 0" in out.stdout
    assert trace.stat().st_size > 0
