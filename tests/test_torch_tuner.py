"""The port's spec `Tuner`, `core.analysis` and `core.tuning` against the
reference's.

On the same numpy keys (the SOSD surrogates) the port's `Tuner` (builds
on the CPU, torch backend) chooses the reference's spec (jnp backend),
with the same `size_bytes`, the same Pareto frontier and `cost_ns`
within 1e-9 relative, since `describe` reads the same build metadata and
the same window widths.  Backend names differ by design: the reference's
"jnp" is the port's "torch".
"""
import jax

jax.config.update("jax_enable_x64", True)

import functools

import numpy as np
import pytest

from repro.core import analysis as ranalysis
from repro.core import base as rbase
from repro.core import spec as rspec
from repro.core import tuning as rtuning
from repro.data import sosd as rsosd
from repro_torch.core import analysis, base, plan, spec, tuning
from repro_torch.kernels.common import encode_keys

N_KEYS = 20_000
REL = 1e-9


@functools.lru_cache(maxsize=None)
def _keys(ds: str):
    return rsosd.generate(ds, N_KEYS, seed=3)


def _ident(sp):
    """A spec's identity with the backend axis mapped jnp -> torch."""
    index, hyper, backend, last_mile = sp.canonical()
    return (index, hyper, {"jnp": "torch", "pallas": "cuda"}.get(
        backend, backend), last_mile)


def _assert_same_search(res, ref):
    assert [_ident(c.spec) for c in res.evaluated] == \
        [_ident(c.spec) for c in ref.evaluated]
    for c, rc in zip(res.evaluated, ref.evaluated):
        assert c.size_bytes == rc.size_bytes, _ident(c.spec)
        assert c.metrics == rc.metrics, _ident(c.spec)
        assert c.cost_ns == pytest.approx(rc.cost_ns, rel=REL)
        assert c.score == pytest.approx(rc.score, rel=REL)
    assert _ident(res.spec) == _ident(ref.spec)
    assert res.build.size_bytes == ref.build.size_bytes
    assert {_ident(c.spec) for c in res.frontier} == \
        {_ident(c.spec) for c in ref.frontier}


@pytest.mark.parametrize("max_bytes", [None, 1 << 14])
@pytest.mark.parametrize("ds", ["amzn", "face", "osm", "wiki"])
def test_tuner_matches_reference(ds, max_bytes):
    keys = _keys(ds)
    res = spec.Tuner(max_bytes=max_bytes, max_configs=2).tune(
        keys, device="cpu")
    ref = rspec.Tuner(max_bytes=max_bytes, max_configs=2).tune(keys)
    _assert_same_search(res, ref)
    assert res.spec.backend == "torch" and res.backend_ns == {}
    assert res.build.meta["spec"] == res.spec
    if max_bytes is not None:
        assert res.build.size_bytes <= max_bytes


def test_tuner_budget_impossible_raises():
    keys = _keys("amzn")
    with pytest.raises(spec.BudgetError, match="max_bytes=8"):
        spec.Tuner(names=("rmi",), max_bytes=8, max_configs=2).tune(
            keys, device="cpu")
    with pytest.raises(rspec.BudgetError):
        rspec.Tuner(names=("rmi",), max_bytes=8, max_configs=2).tune(keys)


def test_tuner_target_ns_picks_smallest_fast_enough():
    keys = _keys("osm")
    names = ("rmi", "pgm", "rbs")
    cheap = spec.Tuner(names=names, max_configs=3).tune(keys, device="cpu")
    # a target between the fastest and the slowest candidate: the smallest
    # of those meeting it wins, not the fastest
    costs = sorted(c.cost_ns for c in cheap.evaluated)
    target = costs[len(costs) // 2]
    res = spec.Tuner(names=names, target_ns=target, max_configs=3).tune(
        keys, device="cpu")
    ref = rspec.Tuner(names=names, target_ns=target, max_configs=3).tune(keys)
    _assert_same_search(res, ref)
    fast = [c for c in res.evaluated if c.score <= target]
    assert res.chosen.size_bytes == min(c.size_bytes for c in fast)
    assert res.chosen.cost_ns <= target
    # an unreachable-high target admits everything: the smallest wins
    big = spec.Tuner(names=names, target_ns=1e12, max_configs=3).tune(
        keys, device="cpu")
    assert big.build.size_bytes == min(c.size_bytes for c in big.evaluated)


def test_tuner_rejects_point_only_names():
    with pytest.raises(spec.SpecError, match="point-only"):
        spec.Tuner(names=("robin_hash",)).tune(_keys("wiki"), device="cpu")


def test_tuner_calibration_rescales_like_the_reference():
    keys = _keys("face")
    cal = {"rmi": 3.0, "pgm": 0.5}
    res = spec.Tuner(names=("rmi", "pgm", "btree"), max_configs=2,
                     calibration=cal).tune(keys, device="cpu")
    ref = rspec.Tuner(names=("rmi", "pgm", "btree"), max_configs=2,
                      calibration=cal).tune(keys)
    _assert_same_search(res, ref)
    assert spec.Tuner(calibration=2.0)._calibration_for("rmi") == 2.0
    assert spec.Tuner(calibration=cal)._calibration_for("rbs") == 1.0


def test_tuner_measures_both_backends_on_the_cpu():
    keys = _keys("wiki")
    res = spec.Tuner(names=("rmi", "pgm"), backends=("torch", "cuda"),
                     max_configs=2, n_queries=256).tune(keys, device="cpu")
    assert set(res.backend_ns) == {"torch", "cuda"}
    assert res.spec.backend == min(res.backend_ns, key=res.backend_ns.get)
    q = rsosd.make_queries(keys, 2_000, seed=9)
    fn = plan.lower(res.build, encode_keys(keys, "cpu")).compile(
        res.spec.backend)
    np.testing.assert_array_equal(fn(encode_keys(q, "cpu")).numpy(),
                                  np.searchsorted(keys, q))
    with pytest.raises(spec.SpecError, match="unknown backend"):
        spec.Tuner(backends=("jnp",)).tune(keys, device="cpu")


def test_tuner_probe_stream_is_the_reference_stream():
    keys = _keys("amzn")
    for n_queries in (64, 2048):
        np.testing.assert_array_equal(
            spec.Tuner(n_queries=n_queries, seed=5)._probe_queries(keys),
            rspec.Tuner(n_queries=n_queries, seed=5)._probe_queries(keys))


def test_tune_shards_matches_reference():
    keys = _keys("osm")
    offsets = [0, 7_000, 13_000, N_KEYS]
    q = rsosd.make_queries(keys, 3_000, seed=4)
    res = spec.Tuner(names=("rmi", "pgm"), max_bytes=1 << 14,
                     max_configs=2).tune_shards(keys, offsets, queries=q,
                                                device="cpu")
    ref = rspec.Tuner(names=("rmi", "pgm"), max_bytes=1 << 14,
                      max_configs=2).tune_shards(keys, offsets, queries=q)
    assert len(res) == len(ref) == 3
    for r, rr in zip(res, ref):
        _assert_same_search(r, rr)
        assert r.build.size_bytes <= (1 << 14) // 3


@pytest.mark.parametrize("name", ["rmi", "pgm", "radix_spline", "btree",
                                  "ibtree", "rbs", "binary_search"])
def test_describe_matches_reference(name):
    keys = _keys("face")
    q = rsosd.make_queries(keys, 1_000, seed=2)
    hyper = rspec.SCHEMAS[name].ladder[len(rspec.SCHEMAS[name].ladder) // 2]
    b = spec.build(spec.IndexSpec(name, dict(hyper)), keys, device="cpu")
    rb = rspec.build(rspec.IndexSpec(name, dict(hyper)), keys)
    lo, hi = b.lookup(b.state, encode_keys(q, "cpu"))
    widths = np.maximum(hi.numpy() - lo.numpy() + 1, 1)
    got = analysis.describe(b, widths)
    assert got == ranalysis.describe(rb, widths)
    assert analysis.cost_ns(got) == ranalysis.cost_ns(got)
    assert analysis.cost_ns(got, calibration=1.7) == \
        ranalysis.cost_ns(got, calibration=1.7)


def test_regress_matches_reference():
    rng = np.random.default_rng(0)
    keys = ("size_bytes", "log2_err", "bytes_touched", "probes", "flops")
    records = [dict({k: float(v) for k, v in zip(keys, rng.random(5))},
                    ns_per_lookup=float(rng.random()) * 100)
               for _ in range(40)]
    assert analysis.regress(records) == ranalysis.regress(records)
    assert analysis.single_metric_r2(records) == \
        ranalysis.single_metric_r2(records)
    assert analysis.COST_NS_WEIGHTS == ranalysis.COST_NS_WEIGHTS


def test_sweep_tables_match_reference():
    assert spec.sweep_names() == rspec.sweep_names()
    assert tuning.DEFAULT_SWEEP == rtuning.DEFAULT_SWEEP
    assert tuning.LADDERS == rtuning.LADDERS
    for k in (None, 0, 1, 2, 3, 5, 9, 20):
        assert [_ident(s) for s in tuning.spec_sweep(max_configs=k)] == \
            [_ident(s) for s in rtuning.spec_sweep(max_configs=k)]
        assert spec.stride_sample(list(range(9)), k) == \
            rspec.stride_sample(list(range(9)), k)
    assert all(s.backend == "cuda"
               for s in tuning.spec_sweep(max_configs=2, backend="cuda"))
    assert [_ident(s) for s in spec.spec_ladder("pgm", 4, last_mile="linear")] \
        == [_ident(s) for s in rspec.spec_ladder("pgm", 4,
                                                 last_mile="linear")]


def test_capped_sweep_builds_match_reference():
    keys = _keys("amzn")
    names = ("pgm", "btree", "rmi")
    got = tuning.sweep(keys, names=names, max_configs=3, device="cpu")
    ref = rtuning.sweep(keys, names=names, max_configs=3)
    assert [b.size_bytes for b in got] == [b.size_bytes for b in ref]
    assert [b.name for b in got] == [b.name for b in ref]
    for name in names:
        sizes = [b.size_bytes for b in got if b.name == name]
        assert sizes[0] == min(sizes) and sizes[-1] == max(sizes)


def test_canonical_is_hashable_identity():
    a = spec.IndexSpec("rmi", {"branching": 64}).validated()
    b = spec.IndexSpec("rmi", {"branching": 64, "stage1": "linear"})
    assert a.canonical() == b.validated().canonical()
    assert len({a.canonical(), b.validated().canonical()}) == 1
    assert a.canonical() != a.replace(backend="cuda").canonical()
    pts = [(3, 3.0, "z"), (1, 2.0, "x"), (2, 1.0, "y"), (2, 1.0, "w")]
    assert base.pareto_front(pts) == rbase.pareto_front(pts) == \
        [(1, 2.0, "x"), (2, 1.0, "w"), (2, 1.0, "y")]
