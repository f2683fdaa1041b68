"""The port's plan transforms against the reference plan's.

Scan, merged, merged-scan, instrumented and instrumented-merged lookups of
the port (both backends; the kernels' plain versions on the CPU) equal the
reference's jnp plan element for element on the same numpy inputs; the
health-stats reduction gives the reference's vector from the same
``(pos, lo, hi, n_valid)``, and `repro.obs.health.unpack_stats` reads it.
"""
import jax

jax.config.update("jax_enable_x64", True)

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import base as rbase
from repro.core import plan as rplan
from repro.data import sosd as rsosd
from repro.obs import health as rhealth
from repro_torch.core import base, plan
from repro_torch.kernels.common import decode_keys, encode_keys

INDEXES = [
    ("rmi", dict(branching=512)),
    ("pgm", dict(eps=32)),
    ("radix_spline", dict(eps=16, radix_bits=12)),
    ("rbs", dict(radix_bits=12)),
    ("btree", dict(sample=8)),
    ("binary_search", {}),
]
HYPER = dict(INDEXES, ibtree=dict(sample=8), robin_hash={})
BACKENDS = ("torch", "cuda")
N_KEYS, N_Q, M = 6_000, 400, 16
UINT64_MAX = np.uint64(2**64 - 1)


@functools.lru_cache(maxsize=None)
def _cell(ds: str):
    keys = rsosd.generate(ds, N_KEYS, seed=3)
    q = np.concatenate([rsosd.make_queries(keys, N_Q, seed=5,
                                           present_frac=0.7),
                        np.array([0, 2**64 - 1], np.uint64),
                        keys[-3:], keys[-1:] + np.uint64(1)])
    # a delta of absent keys, sorted, padded to a power of two
    rng = np.random.default_rng(7)
    delta = np.setdiff1d(rng.integers(int(keys[0]), int(keys[-1]), 300,
                                      dtype=np.uint64), keys)
    padded = np.full(512, UINT64_MAX, np.uint64)
    padded[:len(delta)] = delta
    return keys, q, delta, padded


@functools.lru_cache(maxsize=None)
def _plans(name: str, ds: str):
    keys, _, _, _ = _cell(ds)
    b = base.REGISTRY[name](keys, device="cpu", **HYPER[name])
    rb = rbase.REGISTRY[name](keys, **HYPER[name])
    return (plan.lower(b, encode_keys(keys, "cpu")),
            rplan.lower(rb, jnp.asarray(keys)))


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", [n for n, _ in INDEXES])
def test_scan_matches_reference(name, backend):
    keys, q, _, _ = _cell("face")
    p, rp = _plans(name, "face")
    pos, win = p.compile_scan(M, backend)(encode_keys(q, "cpu"))
    rpos, rwin = rp.compile_scan(M, backend="jnp")(jnp.asarray(q))
    np.testing.assert_array_equal(pos.numpy(), _np(rpos))
    assert win.shape == (len(q), M) and win.dtype == torch.int64
    np.testing.assert_array_equal(decode_keys(win), _np(rwin))
    past = pos.numpy() + M > len(keys)
    assert past.any()
    assert (win.numpy()[past][:, -1] == plan.SENTINEL).all()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", [n for n, _ in INDEXES])
def test_merged_matches_reference(name, backend):
    keys, q, delta, padded = _cell("osm")
    p, rp = _plans(name, "osm")
    qt, dt = encode_keys(q, "cpu"), encode_keys(padded, "cpu")
    got = p.compile_merged(backend)(qt, dt)
    ref = rp.compile_merged(backend="jnp")(jnp.asarray(q),
                                           jnp.asarray(padded))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), _np(ref))
    union = np.union1d(keys, delta)
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(union, q))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", [n for n, _ in INDEXES])
def test_merged_scan_matches_reference(name, backend):
    keys, q, delta, padded = _cell("wiki")
    p, rp = _plans(name, "wiki")
    pos, win = p.compile_merged_scan(M, backend)(encode_keys(q, "cpu"),
                                                 encode_keys(padded, "cpu"))
    rpos, rwin = rp.compile_merged_scan(M, backend="jnp")(
        jnp.asarray(q), jnp.asarray(padded))
    np.testing.assert_array_equal(pos.numpy(), _np(rpos))
    np.testing.assert_array_equal(decode_keys(win), _np(rwin))
    union = np.union1d(keys, delta)
    lb = np.searchsorted(union, q)
    for i in range(0, len(q), 37):
        seg = union[lb[i]:lb[i] + M]
        np.testing.assert_array_equal(decode_keys(win[i])[:len(seg)], seg)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", [n for n, _ in INDEXES])
def test_instrumented_matches_reference(name, backend):
    """Ranks equal the plain lookup's; the packed stats vector equals the
    reference's element for element, pad lanes masked."""
    keys, q, _, _ = _cell("amzn")
    p, rp = _plans(name, "amzn")
    qt = encode_keys(q, "cpu")
    n_valid = len(q) - 37
    pos, packed = p.compile_instrumented(backend)(qt, n_valid)
    rpos, rpacked = rp.compile_instrumented(backend="jnp")(
        jnp.asarray(q), np.int32(n_valid))
    np.testing.assert_array_equal(pos.numpy(), p.compile(backend)(qt).numpy())
    np.testing.assert_array_equal(pos.numpy(), _np(rpos))
    assert packed.dtype == torch.int64
    assert packed.shape == (rhealth.HEALTH_STATS_SIZE,)
    np.testing.assert_array_equal(packed.numpy(), _np(rpacked))
    stats = rhealth.unpack_stats(packed.numpy())
    assert stats["n"] == n_valid
    assert int(stats["traffic_hist"].sum()) == n_valid


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", ["rmi", "pgm", "btree"])
def test_instrumented_merged_matches_reference(name, backend):
    keys, q, delta, padded = _cell("osm")
    p, rp = _plans(name, "osm")
    qt, dt = encode_keys(q, "cpu"), encode_keys(padded, "cpu")
    pos, packed = p.compile_instrumented_merged(backend)(qt, len(q), dt)
    rpos, rpacked = rp.compile_instrumented_merged(backend="jnp")(
        jnp.asarray(q), np.int32(len(q)), jnp.asarray(padded))
    np.testing.assert_array_equal(pos.numpy(), _np(rpos))
    np.testing.assert_array_equal(pos.numpy(),
                                  p.compile_merged(backend)(qt, dt).numpy())
    np.testing.assert_array_equal(packed.numpy(), _np(rpacked))
    _, plain = p.compile_instrumented(backend)(qt, len(q))
    assert torch.equal(packed, plain)      # the stats describe the base


@pytest.mark.parametrize("n", [1_000, 6_000, 2**31 + 5])
@pytest.mark.parametrize("max_err", [1, 77, 4_097])
def test_health_stats_expr_matches_reference(n, max_err):
    """The same (pos, lo, hi, n_valid) in both packages: equal vectors,
    int32 lanes below n = 2^31 and int64 above."""
    rng = np.random.default_rng(n + max_err)
    B = 1_000
    lo = rng.integers(0, n, B)
    hi = np.minimum(lo + rng.integers(0, max_err, B), n)
    pos = np.minimum(lo + rng.integers(0, max_err + 5, B), n)
    for n_valid in (B, 613, 0):
        got = plan.pack_health_stats(plan.health_stats_expr(
            torch.from_numpy(pos), torch.from_numpy(lo), torch.from_numpy(hi),
            n, max_err, n_valid))
        ref = rplan.pack_health_stats(rplan.health_stats_expr(
            jnp.asarray(pos), jnp.asarray(lo), jnp.asarray(hi), n, max_err,
            np.int32(n_valid)))
        np.testing.assert_array_equal(got.numpy(), _np(ref))
        assert rhealth.unpack_stats(got.numpy())["n"] == n_valid


def test_health_geometry_matches_reference():
    assert plan.HEALTH_DISP_BUCKETS == rhealth.HEALTH_DISP_BUCKETS
    assert plan.HEALTH_TRAFFIC_BUCKETS == rhealth.HEALTH_TRAFFIC_BUCKETS
    assert plan.HEALTH_STATS_SIZE == rhealth.HEALTH_STATS_SIZE


@pytest.mark.parametrize("backend", BACKENDS)
def test_point_only_stats_and_refusals(backend):
    """robin_hash: stats count the found lanes; scans and merged lookups
    are refused, as in the reference."""
    keys, q, _, padded = _cell("wiki")
    p, rp = _plans("robin_hash", "wiki")
    qt = encode_keys(q, "cpu")
    pos, packed = p.compile_instrumented(backend)(qt, len(q) - 5)
    rpos, rpacked = rp.compile_instrumented(backend="jnp")(
        jnp.asarray(q), np.int32(len(q) - 5))
    np.testing.assert_array_equal(pos.numpy(), _np(rpos))
    np.testing.assert_array_equal(packed.numpy(), _np(rpacked))
    stats = rhealth.unpack_stats(packed.numpy())
    assert stats["n"] == int((pos.numpy()[:len(q) - 5] >= 0).sum()) > 0
    assert stats["disp_sum"] == 0 and stats["steps_sum"] == 0
    for bad in (lambda: p.scan_expr(4, backend),
                lambda: p.compile_scan(4, backend),
                lambda: p.merged_scan_expr(4, backend),
                lambda: p.instrumented_merged_expr(backend)):
        with pytest.raises(ValueError, match="point-only"):
            bad()
    assert p.build_displacement_quantile() == 0.0


@pytest.mark.parametrize("name", [n for n, _ in INDEXES] + ["ibtree"])
def test_build_displacement_quantile_matches_reference(name):
    p, rp = _plans(name, "osm")
    for quant, sample in ((0.99, 65536), (0.5, 1000)):
        got = p.build_displacement_quantile(quant, sample)
        assert got == rp.build_displacement_quantile(quant, sample)
        assert p.build_displacement_quantile(quant, sample) is got


def test_compiled_transforms_are_cached_per_key():
    p, _ = _plans("pgm", "amzn")
    assert p.compile_scan(8) is p.compile_scan(8)
    assert p.compile_scan(8) is not p.compile_scan(9)
    assert p.compile_scan(8, "cuda") is not p.compile_scan(8)
    assert p.compile_merged() is p.compile_merged("torch")
    assert p.compile_merged_scan(4, "cuda") is p.compile_merged_scan(4, "cuda")
    assert p.compile_instrumented("cuda") is p.compile_instrumented("cuda")
    assert p.compile_instrumented_merged() is p.compile_instrumented_merged()


def test_scan_past_the_end_is_all_sentinel():
    keys, _, _, _ = _cell("amzn")
    p, _ = _plans("rbs", "amzn")
    q = np.full(4, keys[-1] + np.uint64(1), np.uint64)
    pos, win = p.scan(encode_keys(q, "cpu"), 8)
    assert (pos.numpy() == len(keys)).all()
    assert (decode_keys(win) == UINT64_MAX).all()
