"""The port's autotune subsystem against the reference's.

The cases of `tests/test_autotune.py` (without the latency-class
admission cases, which `tests/test_torch_serve_lookup.py` holds) on the
port, on the CPU with the ``torch`` backend:

- `autotune.store`: the dataset fingerprint, the workload signature and
  the store key equal the reference's on the same inputs, and a store
  directory written by either package reads back in the other;
- `autotune.objective`: the probe stream equals the reference's draw for
  draw, and the scores agree within 1e-9 relative;
- `autotune.retuner`: drift -> verified hot swap on both executors (and
  on a routed service), choosing the reference's candidate; every
  rejection path, the store short-circuit, hysteresis and cooldown, the
  mutable republish, the daemon's lifecycle and `/autotune.json`.
"""
import jax

jax.config.update("jax_enable_x64", True)

import functools
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro import autotune as rautotune
from repro.core import analysis as ranalysis
from repro.core import spec as rspec
from repro.data import sosd as rsosd
from repro.serve.lookup import LookupService as RLookupService
from repro.serve.lookup import LookupServiceConfig as RLookupServiceConfig
from repro_torch.autotune import (AutotuneConfig, ShadowRetuner,
                                  SpecArtifactStore, WorkloadObjective,
                                  dataset_fingerprint, tail_weight_from_burn,
                                  workload_queries, workload_signature)
from repro_torch.core import analysis
from repro_torch.core.spec import IndexSpec, Tuner, build
from repro_torch.data import sosd
from repro_torch.obs.export import MetricsServer
from repro_torch.serve.lookup import (LookupService, LookupServiceConfig,
                                      MutableLookupService,
                                      MutableLookupServiceConfig)

CPU = "cpu"
MIS_SPEC = {"sample": 1, "fanout": 2048}


def _keys(n=60_000, seed=7):
    return sosd.generate("amzn", n, seed=seed)


def _hists():
    rng = np.random.default_rng(4)
    flat = np.full(64, 100.0)
    hot = flat.copy()
    hot[3] = 5_000.0
    bottom = np.zeros(64)
    bottom[0] = 1_000.0
    return {"none": None, "zeros": np.zeros(64), "flat": flat, "hot": hot,
            "hot_x7": hot * 7.0, "bottom": bottom,
            "poisson": rng.poisson(50, 64).astype(np.float64),
            "short": np.array([3.0, 0.0, 9.0, 1.0])}


HISTS = sorted(_hists())


# ---------------------------------------------------------------------------
# store: fingerprint, signature, versioned artifacts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["amzn", "tail", "short", "empty", "one",
                                  "big"])
def test_dataset_fingerprint_matches_reference(case):
    keys = {"amzn": _keys(), "tail": _keys()[:-1],
            "short": np.arange(10, dtype=np.uint64),
            "empty": np.empty(0, np.uint64),
            "one": np.array([2**64 - 1], np.uint64),
            "big": sosd.generate("wiki", 200_000, seed=1)}[case]
    assert dataset_fingerprint(keys) == rautotune.dataset_fingerprint(keys)
    assert len(dataset_fingerprint(keys)) == 16


def test_dataset_fingerprint_stable_and_content_sensitive():
    keys = _keys()
    assert dataset_fingerprint(keys) == dataset_fingerprint(keys.copy())
    bumped = keys.copy()
    bumped[-1] += 1
    assert dataset_fingerprint(bumped) != dataset_fingerprint(keys)
    assert dataset_fingerprint(keys[:-1]) != dataset_fingerprint(keys)


@pytest.mark.parametrize("name", HISTS)
def test_workload_signature_matches_reference(name):
    h = _hists()[name]
    assert workload_signature(h) == rautotune.workload_signature(h)
    for levels in (2, 4, 16):
        assert workload_signature(h, levels) == \
            rautotune.workload_signature(h, levels)


def test_workload_signature_quantizes_noise_splits_hot_spots():
    h = _hists()
    assert workload_signature(None) == "uniform"
    assert workload_signature(h["zeros"]) == "uniform"
    assert workload_signature(h["flat"]) == "uniform"
    assert workload_signature(h["hot"]) != "uniform"
    assert workload_signature(h["hot"]) == workload_signature(h["hot_x7"])


@pytest.mark.parametrize("budget", [None, 0, 1024, 131072])
def test_store_key_matches_reference(budget):
    fp = dataset_fingerprint(_keys(20_000))
    sig = workload_signature(_hists()["hot"])
    assert SpecArtifactStore.key(fp, budget, sig) == \
        rautotune.SpecArtifactStore.key(fp, budget, sig)


def test_store_round_trip_versions_and_stats(tmp_path):
    store = SpecArtifactStore(str(tmp_path))
    sp = IndexSpec("rmi", {"branching": 256}).validated()
    assert store.get("fp", 1024, "uniform") is None
    a1 = store.put("fp", 1024, "uniform", [sp], score=12.5,
                   meta={"trigger": "workload_drift"})
    assert a1.version == 1
    got = store.get("fp", 1024, "uniform")
    assert got is not None and got.version == 1
    assert got.specs[0].canonical() == sp.canonical()
    assert got.score == 12.5 and got.meta["trigger"] == "workload_drift"
    sp2 = IndexSpec("rmi", {"branching": 1024}).validated()
    a2 = store.put("fp", 1024, "uniform", [sp2], score=9.0)
    assert a2.version == 2
    assert store.get("fp", 1024, "uniform").specs[0].canonical() == \
        sp2.canonical()
    assert store.get("fp", 2048, "uniform") is None
    assert store.get("fp", 1024, "h0123") is None
    assert store.stats() == {"hits": 2, "misses": 3}
    entry, = [e for e in store.entries()
              if e["key"] == store.key("fp", 1024, "uniform")]
    assert entry["n_versions"] == 2


def test_store_written_by_one_package_reads_in_the_other(tmp_path):
    keys = _keys(20_000)
    fp = dataset_fingerprint(keys)
    sig = workload_signature(_hists()["bottom"])
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref = rautotune.SpecArtifactStore(str(ref_dir))
    ref_specs = [rspec.IndexSpec("pgm", {"eps": 16}).validated(),
                 rspec.IndexSpec("rmi", {"branching": 512}).validated()]
    ref.put(fp, 4096, sig, ref_specs, score=3.25,
            meta={"trigger": "slo_burn"})
    got = SpecArtifactStore(str(ref_dir)).get(fp, 4096, sig)
    assert got is not None and got.version == 1 and got.score == 3.25
    assert [(s.index, s.hyper) for s in got.specs] == \
        [(s.index, s.hyper) for s in ref_specs]
    assert got.meta == {"trigger": "slo_burn"}
    # and the other way round, appending to the same key
    port = SpecArtifactStore(str(port_dir))
    port.put(fp, 4096, sig, [IndexSpec("btree", {"sample": 8}).validated()],
             score=1.5)
    port.put(fp, 4096, sig, [IndexSpec("btree", {"sample": 4}).validated()],
             score=1.0)
    back = rautotune.SpecArtifactStore(str(port_dir)).get(fp, 4096, sig)
    assert back.version == 2 and back.specs[0].index == "btree"
    assert back.specs[0].hyper["sample"] == 4
    assert sorted(p.name for p in port_dir.iterdir()) == \
        [rautotune.SpecArtifactStore.key(fp, 4096, sig) + ".json"]


def test_store_lookup_or_tune_runs_fn_once(tmp_path):
    store = SpecArtifactStore(str(tmp_path))
    sp = IndexSpec("btree", {"sample": 8}).validated()
    calls = []

    def tune_fn():
        calls.append(1)
        return [sp], 3.0, {"trigger": "t"}

    art, hit = store.lookup_or_tune("fp", None, "uniform", tune_fn)
    assert not hit and art.version == 1 and len(calls) == 1
    art2, hit2 = store.lookup_or_tune("fp", None, "uniform", tune_fn)
    assert hit2 and len(calls) == 1
    assert art2.specs[0].canonical() == sp.canonical()


# ---------------------------------------------------------------------------
# objective: workload-drawn probes, tail weighting, calibration
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", HISTS)
def test_workload_queries_match_reference(name):
    keys = _keys(20_000)
    h = _hists()[name]
    for n, seed, frac in ((64, 0, 0.25), (2_048, 3, 0.0), (4_096, 9, 0.5)):
        got = workload_queries(keys, h, n, seed=seed, absent_frac=frac)
        want = rautotune.workload_queries(keys, h, n, seed=seed,
                                          absent_frac=frac)
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(got, want)


def test_workload_queries_follow_traffic_histogram():
    keys = _keys()
    q = workload_queries(keys, _hists()["bottom"], 4_096, seed=3,
                         absent_frac=0.25)
    assert q.dtype == np.uint64 and len(q) == 4_096
    edge_key = keys[(len(keys) + 63) // 64]
    assert float(np.mean(q < edge_key)) > 0.6
    q_flat = workload_queries(keys, None, 4_096, seed=3)
    assert float(np.mean(q_flat < edge_key)) < 0.1


@pytest.mark.parametrize("burn", [0.0, 0.5, 2.0, 4.0, 1e9, -3.0])
def test_tail_weight_from_burn_matches_reference(burn):
    assert tail_weight_from_burn(burn) == \
        rautotune.tail_weight_from_burn(burn)
    assert 1.0 <= tail_weight_from_burn(burn) <= 5.0


OBJECTIVES = [dict(), dict(tail_weight=5.0), dict(calibration=2.0),
              dict(calibration={"rmi": 0.25, "btree": 3.0},
                   tail_weight=2.5)]


@pytest.mark.parametrize("obj", range(len(OBJECTIVES)))
@pytest.mark.parametrize("index,hyper", [
    ("rmi", {"branching": 64}), ("btree", {"sample": 1, "fanout": 2048}),
    ("pgm", {"eps": 16})])
def test_objective_scores_match_reference(index, hyper, obj):
    """The same build on the same workload-drawn queries: widths, the
    described metrics and the objective score agree with the reference's
    within 1e-9 relative."""
    keys = _keys(30_000)
    hist = _hists()["bottom"]
    kw = OBJECTIVES[obj]
    port_obj = WorkloadObjective(traffic_hist=hist, n_queries=1_024, **kw)
    ref_obj = rautotune.WorkloadObjective(traffic_hist=hist,
                                          n_queries=1_024, **kw)
    q = port_obj.queries(keys)
    np.testing.assert_array_equal(q, ref_obj.queries(keys))
    sp = IndexSpec(index, hyper).validated()
    rsp = rspec.IndexSpec(index, hyper).validated()
    b = build(sp, keys, device=CPU)
    rb = rspec.build(rsp, keys)
    from repro_torch.kernels.common import encode_keys
    import jax.numpy as jnp
    lo, hi = b.lookup(b.state, encode_keys(q, CPU))
    widths = np.maximum(hi.numpy() - lo.numpy() + 1, 1)
    rlo, rhi = rb.lookup(rb.state, jnp.asarray(q))
    rwidths = np.maximum(np.asarray(rhi) - np.asarray(rlo) + 1, 1)
    np.testing.assert_array_equal(widths, rwidths)
    got = port_obj.score(sp, analysis.describe(b, widths), widths)
    want = ref_obj.score(rsp, ranalysis.describe(rb, rwidths), rwidths)
    assert got == pytest.approx(want, rel=1e-9)
    assert port_obj.describe() == ref_obj.describe()


def test_objective_tail_weight_penalizes_wide_tails():
    keys = _keys()
    sp = IndexSpec("rmi", {"branching": 64}).validated()
    b = build(sp, keys, device=CPU)
    widths = np.ones(2_048)
    widths[-64:] = 4_096
    metrics = analysis.describe(b, widths)
    lo = WorkloadObjective(tail_weight=1.0).score(sp, metrics, widths)
    hi = WorkloadObjective(tail_weight=5.0).score(sp, metrics, widths)
    assert hi > lo
    flat = np.full(2_048, 8.0)
    m2 = analysis.describe(b, flat)
    assert WorkloadObjective(tail_weight=5.0).score(sp, m2, flat) == \
        pytest.approx(WorkloadObjective(tail_weight=1.0).score(sp, m2, flat))


def test_calibration_pin_miscalibrated_proxy_no_longer_flips_choice():
    """The tuner's cross-family choice follows a measured
    ``cost_model_ratio``: a ratio that makes the uncalibrated winner's
    proxy optimistic flips the choice; a ratio of 1.0 changes nothing."""
    keys = _keys(30_000)
    tuner = Tuner(names=("rmi", "btree"), max_configs=4)
    res = tuner.tune(keys, device=CPU)
    win_family = res.spec.index
    other_family = "btree" if win_family == "rmi" else "rmi"
    best = {}
    for c in res.evaluated:
        best[c.spec.index] = min(best.get(c.spec.index, float("inf")),
                                 c.cost_ns)
    assert best[win_family] <= best[other_family]
    ratio = 1.01 * best[other_family] / best[win_family]
    flipped = Tuner(names=("rmi", "btree"), max_configs=4,
                    calibration={win_family: ratio}).tune(keys, device=CPU)
    assert flipped.spec.index == other_family
    control = Tuner(names=("rmi", "btree"), max_configs=4,
                    calibration={win_family: 1.0}).tune(keys, device=CPU)
    assert control.spec.index == win_family


# ---------------------------------------------------------------------------
# retuner: the state machine on a live service
# ---------------------------------------------------------------------------
def _at(**kw):
    cfg = dict(hysteresis_s=0.0, cooldown_s=0.0, window_s=1.0,
               verify_queries=512, calibrate=False,
               tuner=Tuner(names=("btree",), max_configs=4))
    cfg.update(kw)
    return AutotuneConfig(**cfg)


def _mis_service(keys, executor="sync", shards=1, **at_kw):
    """Service stranded on the reference's deliberately mis-tuned btree
    (every descent level scans 2049 node keys) with a manual-poll
    retuner attached."""
    return LookupService(keys, LookupServiceConfig(
        spec=IndexSpec("btree", MIS_SPEC).validated(),
        max_batch=512, executor=executor, warm_buckets=(512,),
        shards=shards, autotune=_at(**at_kw)), device=CPU)


def _drift_traffic(svc, keys, n=1_024):
    """Hot-spot traffic (bottom 1/64 of the key space), aged past the
    warm-up so the drift window holds the shift only; the rules are
    evaluated before the poll."""
    time.sleep(1.2)
    hot = np.random.default_rng(0).choice(
        keys[: max(1, len(keys) // 64)], size=n)
    np.testing.assert_array_equal(svc.lookup(hot),
                                  np.searchsorted(keys, hot))
    svc.check_alerts(window_s=1.0)
    return hot


@functools.lru_cache(maxsize=None)
def _reference_swap():
    keys = rsosd.generate("amzn", 60_000, seed=7)
    at = rautotune.AutotuneConfig(
        hysteresis_s=0.0, cooldown_s=0.0, window_s=1.0, verify_queries=512,
        calibrate=False,
        tuner=rspec.Tuner(names=("btree",), max_configs=4,
                          backends=("jnp",)))
    svc = RLookupService(keys, RLookupServiceConfig(
        spec=rspec.IndexSpec("btree", MIS_SPEC).validated(),
        max_batch=512, warm_buckets=(512,), autotune=at))
    with svc:
        _drift_traffic(svc, keys)
        return svc.autotune.poll_once()


def _family(specs):
    """Spec identities without the backend (the packages name theirs
    differently)."""
    return [(s[0], tuple(tuple(h) for h in s[1]), s[3]) for s in specs]


@pytest.mark.parametrize("executor", ["sync", "async"])
def test_e2e_drift_triggers_verified_swap_bit_identical(executor):
    """Hot-spot skew fires `workload_drift` through the real alert path,
    one poll lands a VERIFIED hot swap onto the reference's candidate,
    and served positions equal the oracle before and after."""
    keys = _keys()
    svc = _mis_service(keys, executor=executor)
    with svc:
        v0 = svc.registry.current().version
        _drift_traffic(svc, keys)
        assert "workload_drift" in svc.alerts.firing()
        d = svc.autotune.poll_once()
        assert d is not None and d["action"] == "swapped", d
        assert d["trigger"] == "workload_drift"
        assert d["verify"]["divergent"] == 0
        assert d["candidate"]["specs"][0] != d["incumbent"]["specs"][0]
        # the swap's seconds, step by step, add up to within its total
        steps = d["timing_s"]
        assert list(steps) == ["signals", "search", "build_score",
                               "verify", "publish"]
        assert all(v >= 0 for v in steps.values())
        assert sum(steps.values()) <= d["duration_s"] + 1e-3
        ref = _reference_swap()
        assert ref["action"] == "swapped"
        assert _family(d["candidate"]["specs"]) == \
            _family(ref["candidate"]["specs"])
        assert d["candidate"]["score"] == ref["candidate"]["score"]
        assert d["incumbent"]["score"] == ref["incumbent"]["score"]
        gen = svc.registry.current()
        assert gen.version > v0
        assert gen.spec.canonical() == tuple(d["candidate"]["specs"][0])
        q = sosd.make_queries(keys, 2_000, seed=13, present_frac=0.5)
        np.testing.assert_array_equal(svc.lookup(q),
                                      np.searchsorted(keys, q))
        assert svc.autotune.n_swapped == 1
        snap = svc.health_snapshot(window_s=60.0)
        assert snap["autotune_swapped"] == 1
        assert snap["autotune_triggered"] == 1


@pytest.mark.parametrize("executor", ["sync", "async"])
def test_routed_drift_swaps_every_shard_through_publish_routed(executor):
    """On a routed service the retune searches each shard's slice and
    publishes the verified shard set as one routed generation over the
    same topology."""
    keys = _keys()
    svc = _mis_service(keys, executor=executor, shards=2)
    with svc:
        old = svc.generation
        _drift_traffic(svc, keys)
        d = svc.autotune.poll_once()
        assert d is not None and d["action"] == "swapped", d
        assert len(d["candidate"]["specs"]) == 2
        gen = svc.generation
        assert gen.topology is old.topology
        assert gen.version > old.version
        assert set(gen.shard_versions).isdisjoint(old.shard_versions)
        assert [g.spec.canonical() for g in gen.shards] == \
            [tuple(s) for s in d["candidate"]["specs"]]
        q = sosd.make_queries(keys, 2_000, seed=13, present_frac=0.5)
        np.testing.assert_array_equal(svc.lookup(q),
                                      np.searchsorted(keys, q))
        assert svc.health_snapshot(60.0)["health_shards"] == 2.0


def test_rejection_cost_is_truthful_and_does_not_swap():
    keys = _keys()
    svc = LookupService(keys, LookupServiceConfig(
        spec=IndexSpec("btree", {"sample": 1, "fanout": 64}).validated(),
        max_batch=512, warm_buckets=(512,), autotune=_at(min_win=0.05)),
        device=CPU)
    with svc:
        v0 = svc.registry.current().version
        d = svc.autotune.poll_once(force_trigger="workload_drift")
        assert d["action"] == "rejected" and d["reason"] == "cost"
        assert d["candidate"]["score"] > d["incumbent"]["score"] * 0.95
        assert svc.registry.current().version == v0
        assert svc.autotune.n_rejected == 1 and svc.autotune.n_swapped == 0


def test_rejection_no_better_spec_when_incumbent_is_the_ladder_winner():
    keys = _keys()
    probe = Tuner(names=("btree",), max_configs=4).tune(keys, device=CPU)
    svc = LookupService(keys, LookupServiceConfig(
        spec=probe.spec, max_batch=512, warm_buckets=(512,),
        autotune=_at(window_s=10.0)), device=CPU)
    with svc:
        d = svc.autotune.poll_once(force_trigger="workload_drift")
        assert d["action"] == "rejected"
        assert d["reason"] == "no_better_spec"


def test_budget_violation_waives_cost_margin():
    """An incumbent OVER the tuner's byte cap is swapped out even when
    its modeled cost beats every budgeted candidate (basis "budget");
    one within the cap keeps the margin gate."""
    keys = _keys()
    cap = 128 * 1024

    def mk(branching):
        return LookupService(keys, LookupServiceConfig(
            spec=IndexSpec("rmi", {"branching": branching}).validated(),
            max_batch=512, warm_buckets=(512,),
            autotune=_at(window_s=10.0, min_win=0.05,
                         tuner=Tuner(names=("rmi",), max_configs=6,
                                     max_bytes=cap))), device=CPU)

    svc = mk(65536)
    with svc:
        assert svc.registry.current().build.size_bytes > cap
        d = svc.autotune.poll_once(force_trigger="slo_burn")
        assert d["action"] == "swapped", d
        assert d["basis"] == "budget"
        assert d["candidate"]["score"] > d["incumbent"]["score"]
        assert svc.registry.current().build.size_bytes <= cap
        q = sosd.make_queries(keys, 1_500, seed=3, present_frac=0.5)
        np.testing.assert_array_equal(svc.lookup(q),
                                      np.searchsorted(keys, q))
    svc2 = mk(4096)
    with svc2:
        assert svc2.registry.current().build.size_bytes <= cap
        d2 = svc2.autotune.poll_once(force_trigger="slo_burn")
        assert d2["action"] == "rejected"
        assert d2["reason"] in ("cost", "no_better_spec")


def test_verify_failure_rejects_and_never_publishes(monkeypatch):
    keys = _keys()
    svc = _mis_service(keys)
    with svc:
        v0 = svc.registry.current().version
        monkeypatch.setattr(ShadowRetuner, "_verify_fn",
                            lambda self, fn, k, q: (False, 7))
        d = svc.autotune.poll_once(force_trigger="workload_drift")
        assert d["action"] == "rejected" and d["reason"] == "verify"
        assert d["verify"]["divergent"] == 7
        assert svc.registry.current().version == v0
        assert svc.autotune.n_verify_failures == 1


def test_verify_fn_counts_divergent_lanes():
    """The verifier runs the candidate's compiled lookup on the device
    and counts every lane that differs from ``np.searchsorted``."""
    keys = _keys(20_000)
    svc = _mis_service(keys)
    gen = svc.generation
    q = sosd.make_queries(keys, 500, seed=2, present_frac=0.5)
    assert svc.autotune._verify_fn(gen.fn, keys, q) == (True, 0)
    off_by_one = lambda t: gen.fn(t) + 1    # noqa: E731
    assert svc.autotune._verify_fn(off_by_one, keys, q) == (False, 500)
    assert svc.autotune._verify_fn(gen.fn, keys, q[:0]) == (True, 0)


def test_retune_error_is_recorded_not_raised():
    keys = _keys()
    svc = LookupService(keys, LookupServiceConfig(
        max_batch=512, warm_buckets=(512,),
        autotune=_at(window_s=10.0, verify_queries=256,
                     tuner=Tuner(names=("no_such_index",)))), device=CPU)
    with svc:
        d = svc.autotune.poll_once(force_trigger="workload_drift")
        assert d["action"] == "error" and d["reason"]
        assert svc.autotune.n_errors == 1
        assert svc.autotune.last_error


def test_store_short_circuits_second_attempt(tmp_path):
    keys = _keys()
    svc = _mis_service(keys, store_dir=str(tmp_path))
    with svc:
        _drift_traffic(svc, keys)
        d = svc.autotune.poll_once()
        assert d["action"] == "swapped" and not d["cache_hit"]
        assert svc.autotune.n_sweeps == 1
        _drift_traffic(svc, keys)
        d2 = svc.autotune.poll_once()
        assert d2 is not None and d2["cache_hit"], d2
        assert d2["action"] == "rejected"
        assert d2["reason"] == "no_better_spec"
        assert svc.autotune.n_sweeps == 1
        assert svc.autotune.store.stats()["hits"] >= 1
    # a second service over the same store directory starts warm: its
    # first attempt reads the artifact and runs no sweep
    svc2 = _mis_service(keys, store_dir=str(tmp_path))
    with svc2:
        _drift_traffic(svc2, keys)
        d3 = svc2.autotune.poll_once()
        assert d3["action"] == "swapped" and d3["cache_hit"], d3
        assert not d3["swept"] and svc2.autotune.n_sweeps == 0
        assert d3["candidate"]["specs"] == d["candidate"]["specs"]


def test_hysteresis_and_cooldown_gate_attempts():
    keys = _keys()
    svc = LookupService(keys, LookupServiceConfig(
        spec=IndexSpec("btree", MIS_SPEC).validated(),
        max_batch=512, warm_buckets=(512,),
        autotune=_at(hysteresis_s=3600.0, cooldown_s=3600.0,
                     verify_queries=256,
                     tuner=Tuner(names=("btree",), max_configs=2))),
        device=CPU)
    with svc:
        _drift_traffic(svc, keys)
        assert "workload_drift" in svc.alerts.firing()
        assert svc.autotune.poll_once() is None
        assert svc.autotune.n_triggered == 0
        d = svc.autotune.poll_once(force_trigger="workload_drift")
        assert d is not None
        assert svc.autotune.poll_once() is None


@pytest.mark.parametrize("executor", ["sync", "async"])
def test_mutable_service_retunes_through_republish(executor):
    """The swap goes through `MutableIndex.republish`, so delta inserts
    made before the retune stay served after it."""
    keys = _keys(30_000)
    svc = MutableLookupService(keys, MutableLookupServiceConfig(
        spec=IndexSpec("btree", MIS_SPEC).validated(),
        max_batch=512, warm_buckets=(512,), auto_compact=False,
        executor=executor, autotune=_at(window_s=10.0)), device=CPU)
    with svc:
        gaps = keys[:-1][np.diff(keys) > 1] + 1
        ins = gaps[:64].astype(np.uint64)
        svc.insert(ins).result(timeout=60.0)
        d = svc.autotune.poll_once(force_trigger="workload_drift")
        assert d["action"] == "swapped", d
        assert svc.mindex.delta_count == 64
        merged = np.sort(np.concatenate([keys, ins]))
        q = sosd.make_queries(merged, 1_500, seed=4, present_frac=0.6)
        np.testing.assert_array_equal(svc.lookup(q),
                                      np.searchsorted(merged, q))


def test_daemon_thread_lifecycle_and_status():
    keys = _keys(20_000)
    svc = LookupService(keys, LookupServiceConfig(
        max_batch=512, warm_buckets=(512,),
        autotune=AutotuneConfig(daemon=True, poll_s=0.05,
                                hysteresis_s=3600.0, calibrate=False)),
        device=CPU)
    assert not svc.autotune.alive
    with svc:
        deadline = time.perf_counter() + 10.0
        while svc.autotune.n_polls == 0 and time.perf_counter() < deadline:
            time.sleep(0.02)
        assert svc.autotune.alive
        assert svc.autotune.n_polls >= 1
        st = svc.autotune.status()
        assert st["alive"] and st["daemon"]
        snap = svc.health_snapshot(window_s=60.0)
        assert snap["autotune_alive"] == 1.0
    assert not svc.autotune.alive


def test_autotune_json_surface(tmp_path):
    keys = _keys(20_000)
    svc = _mis_service(keys, store_dir=str(tmp_path))
    with svc:
        svc.autotune.poll_once(force_trigger="workload_drift")
        with MetricsServer(svc, port=0) as ms:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{ms.port}/autotune.json",
                    timeout=10) as r:
                assert r.status == 200
                doc = json.loads(r.read().decode())
        assert doc["counters"]["triggered"] == 1
        assert doc["counters"]["swapped"] + doc["counters"]["rejected"] \
            + doc["counters"]["errors"] == 1
        assert doc["decisions"][-1]["trigger"] == "workload_drift"
        assert doc["config"]["triggers"]
        assert "store" in doc
    plain = LookupService(keys, LookupServiceConfig(max_batch=512),
                          device=CPU)
    with plain:
        with MetricsServer(plain, port=0) as ms:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{ms.port}/autotune.json", timeout=10)
            assert ei.value.code == 404


def test_calibration_reads_the_profiler_ratio():
    """With ``calibrate`` on, the incumbent family's proxy is rescaled by
    the port profiler's measured ``cost_model_ratio``."""
    keys = _keys(20_000)
    svc = LookupService(keys, LookupServiceConfig(
        spec=IndexSpec("pgm", {"eps": 64}).validated(), max_batch=512),
        device=CPU)
    rt = ShadowRetuner(svc, AutotuneConfig(calibrate=True))
    cal = rt._measure_calibration(svc.generation, None, keys)
    assert set(cal) == {"pgm"} and cal["pgm"] > 0
    assert ShadowRetuner(svc, AutotuneConfig(calibrate=False)) \
        ._measure_calibration(svc.generation, None, keys) is None


def test_warm_wait_is_a_noop_when_idle():
    keys = _keys(20_000)
    svc = LookupService(keys, LookupServiceConfig(max_batch=512),
                        device=CPU)
    with svc:
        svc.warm_wait()
        q = sosd.make_queries(keys, 200, seed=1, present_frac=0.5)
        np.testing.assert_array_equal(svc.lookup(q),
                                      np.searchsorted(keys, q))
