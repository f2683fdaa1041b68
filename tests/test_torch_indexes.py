"""The port's index families against the reference and np.searchsorted.

Every family of the reference's plan matrix (6 indexes x 4 surrogates x 3
last miles): the port's "torch" backend, its "cuda" backend (the plain
version of the bounded-search kernel on the CPU), the reference's jnp plan
and np.searchsorted agree bit for bit.  Also: bounds equal the reference's
(integer families bit for bit), the point-only hash and IBTree, validity
on the shared SOSD fixtures, schemas and ladders, converting reference
builds, and the uint64 shift and hash arithmetic on int64 tensors.
"""
import jax

jax.config.update("jax_enable_x64", True)

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import base as rbase
from repro.core import plan as rplan
from repro.core import spec as rspec
from repro.data import sosd as rsosd
from repro_torch import convert
from repro_torch.core import base, hashmap, plan, radix_spline, spec, validate
from repro_torch.kernels.common import decode_keys, encode_keys, radix_prefix

DATASETS = ("amzn", "face", "osm", "wiki")
INDEXES = [
    ("rmi", dict(branching=512)),
    ("pgm", dict(eps=32)),
    ("radix_spline", dict(eps=16, radix_bits=12)),
    ("rbs", dict(radix_bits=12)),
    ("btree", dict(sample=8)),
    ("binary_search", {}),
]
OTHERS = [("ibtree", dict(sample=8)), ("robin_hash", dict(load_factor=0.5))]
HYPER = dict(INDEXES + OTHERS)
LAST_MILES = ("binary", "linear", "interpolation")
N_KEYS, N_Q = 8_000, 512
EXTREMES = np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 1], np.uint64)
#: lanes on which an f64 family's (lo, hi) may differ from the reference's
#: (XLA may contract the reference's multiply-add into an FMA; none
#: differ on the jax this suite was written against)
F64_BOUND_LANES = 4


@functools.lru_cache(maxsize=None)
def _cell(ds: str):
    keys = rsosd.generate(ds, N_KEYS, seed=3)
    q = np.concatenate([
        rsosd.make_queries(keys, N_Q, seed=5, present_frac=0.7), EXTREMES,
        keys[:1] - np.uint64(1), keys[-1:] + np.uint64(1)])
    return keys, q, np.searchsorted(keys, q)


@functools.lru_cache(maxsize=None)
def _pair(name: str, ds: str):
    """(port build, reference build) of one family on one surrogate."""
    keys, _, _ = _cell(ds)
    return (base.REGISTRY[name](keys, device="cpu", **HYPER[name]),
            rbase.REGISTRY[name](keys, **HYPER[name]))


def _ref_rank(rb, keys, q, last_mile=None):
    p = rplan.lower(rb, jnp.asarray(keys), last_mile=last_mile)
    return np.asarray(p.compile(backend="jnp")(jnp.asarray(q)))


# ---------------------------------------------------------------------------
# The parity matrix
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lm", LAST_MILES)
@pytest.mark.parametrize("ds", DATASETS)
@pytest.mark.parametrize("name", [n for n, _ in INDEXES])
def test_parity_matrix(name, ds, lm):
    keys, q, lb = _cell(ds)
    b, rb = _pair(name, ds)
    p = plan.lower(b, encode_keys(keys, "cpu"), last_mile=lm)
    qt = encode_keys(q, "cpu")
    got_torch = p.compile("torch")(qt)
    got_cuda = p.compile("cuda", fused=False)(qt)
    ref = _ref_rank(rb, keys, q, lm)
    assert got_torch.dtype == got_cuda.dtype == torch.int64
    np.testing.assert_array_equal(ref, lb)
    np.testing.assert_array_equal(got_torch.numpy(), lb)
    np.testing.assert_array_equal(got_cuda.numpy(), lb)


@pytest.mark.parametrize("ds", DATASETS)
@pytest.mark.parametrize("name", [n for n, _ in INDEXES[1:]])
def test_bounds_match_reference(name, ds):
    """Both packages' bounds hold LB; integer families' bounds are the
    reference's bit for bit, f64 ones on all but `F64_BOUND_LANES`."""
    keys, q, lb = _cell(ds)
    b, rb = _pair(name, ds)
    lo, hi = b.lookup(b.state, encode_keys(q, "cpu"))
    rlo, rhi = (np.asarray(x) for x in rb.lookup(rb.state, jnp.asarray(q)))
    for a, z in ((lo.numpy(), hi.numpy()), (rlo, rhi)):
        assert ((a <= lb) & (lb <= z)).all()
        assert (z - a + 1).max() <= b.meta["max_err"]
    differ = int(((lo.numpy() != rlo) | (hi.numpy() != rhi)).sum())
    assert differ <= (F64_BOUND_LANES if name in ("pgm", "radix_spline")
                      else 0)
    assert b.meta["max_err"] == rb.meta["max_err"]
    assert b.hyper == rb.hyper and b.size_bytes == rb.size_bytes


@pytest.mark.parametrize("ds", DATASETS)
@pytest.mark.parametrize("name", [n for n, _ in OTHERS])
def test_point_lookups_match_reference(name, ds):
    """IBTree (interpolation last mile) and the point-only Robin Hood
    hash: both port backends return the reference's answers."""
    keys, q, lb = _cell(ds)
    b, rb = _pair(name, ds)
    p = plan.lower(b, encode_keys(keys, "cpu"))
    qt = encode_keys(q, "cpu")
    ref = _ref_rank(rb, keys, q)
    for backend in ("torch", "cuda"):
        np.testing.assert_array_equal(p.compile(backend)(qt).numpy(), ref)
    assert b.hyper == rb.hyper and b.size_bytes == rb.size_bytes
    if name == "ibtree":
        assert p.last_mile == "interpolation" and not p.point_only
        np.testing.assert_array_equal(ref, lb)
        return
    assert p.point_only and p.bounds.max_err == 0
    present = np.isin(q, keys)
    assert present.any() and (~present).any()
    assert (keys[ref[present]] == q[present]).all()
    assert (ref[~present] == -1).all()
    for k in ("slot_key", "slot_val"):
        got = b.state[k]
        got = decode_keys(got) if k == "slot_key" else got.numpy()
        np.testing.assert_array_equal(got, np.asarray(rb.state[k]))


def test_point_only_plan_compiles_one_callable_for_both_backends():
    keys, _, _ = _cell("wiki")
    b, _ = _pair("robin_hash", "wiki")
    p = plan.lower(b, encode_keys(keys, "cpu"))
    assert p.compile("cuda") is p.compile("cuda", fused=False)
    assert p.compile("torch") is not p.compile("cuda")


# ---------------------------------------------------------------------------
# Validity on the shared SOSD fixtures (tests/test_core_validity.py's shape)
# ---------------------------------------------------------------------------
INDEX_CONFIGS = [
    ("pgm", dict(eps=16)),
    ("pgm", dict(eps=128)),
    ("radix_spline", dict(eps=16, radix_bits=12)),
    ("btree", dict(sample=8)),
    ("ibtree", dict(sample=8)),
    ("rbs", dict(radix_bits=10)),
    ("binary_search", dict()),
]


@pytest.mark.parametrize("name,hyper", INDEX_CONFIGS, ids=[
    f"{n}-{i}" for i, (n, _) in enumerate(INDEX_CONFIGS)])
@pytest.mark.parametrize("ds", DATASETS)
def test_bounds_valid_on_sosd(datasets, queries, ds, name, hyper):
    keys = datasets[ds]
    q = np.concatenate([queries[ds], EXTREMES, keys[:1] - np.uint64(1),
                        keys[-1:] + np.uint64(1)])
    b = base.REGISTRY[name](keys, device="cpu", **hyper)
    for qs in (q, keys):
        r = validate.check_bounds(b, keys, qs)
        assert r["valid"], (ds, name, hyper, r)
        assert r["max_width"] <= b.meta["max_err"]


@pytest.mark.parametrize("name,hyper", INDEX_CONFIGS, ids=[
    f"{n}-{i}" for i, (n, _) in enumerate(INDEX_CONFIGS)])
def test_end_to_end_exact(datasets, queries, name, hyper):
    keys = datasets["wiki"]
    b = base.REGISTRY[name](keys, device="cpu", **hyper)
    for lm in ("binary", "interpolation"):
        r = validate.check_end_to_end(b, keys, queries["wiki"], last_mile=lm)
        assert r["exact"], (name, lm, r)


def test_binary_search_has_no_state():
    keys, q, lb = _cell("amzn")
    b = base.REGISTRY["binary_search"](keys, device="cpu")
    assert b.size_bytes == 0 and b.state == {}
    assert b.device == torch.device("cpu")
    assert validate.check_end_to_end(b, keys, q)["exact"]


# ---------------------------------------------------------------------------
# Registry, schemas and ladders
# ---------------------------------------------------------------------------
def test_registry_matches_reference():
    assert sorted(base.REGISTRY) == sorted(rbase.REGISTRY)
    assert sorted(spec.SCHEMAS) == sorted(rspec.SCHEMAS) == \
        sorted(base.REGISTRY)


@pytest.mark.parametrize("name", sorted(rspec.SCHEMAS))
def test_schema_matches_reference_and_signature(name):
    s, rs = spec.SCHEMAS[name], rspec.SCHEMAS[name]
    fields = [(f.name, f.type, f.default, f.choices, f.lo, f.hi)
              for f in s.fields]
    assert fields == [(f.name, f.type, f.default, f.choices, f.lo, f.hi)
                      for f in rs.fields]
    assert s.ladder == rs.ladder
    assert (s.sweep, s.sweep_exclude_reason) == \
        (rs.sweep, rs.sweep_exclude_reason)
    params = inspect.signature(base.REGISTRY[name]).parameters
    for f in s.fields:
        assert params[f.name].default == f.default, (name, f.name)
    assert params["device"].default is None


def test_spec_build_every_family():
    keys, q, lb = _cell("osm")
    qt = encode_keys(q, "cpu")
    for name in sorted(spec.SCHEMAS):
        b = spec.build(spec.IndexSpec(name), keys, device="cpu")
        assert b.meta["spec"] == spec.IndexSpec(name).validated()
        got = plan.lower(b, encode_keys(keys, "cpu")).compile("cuda")(qt)
        if name == "robin_hash":
            found = np.isin(q, keys)
            np.testing.assert_array_equal(got.numpy()[found], lb[found])
        else:
            np.testing.assert_array_equal(got.numpy(), lb)


# ---------------------------------------------------------------------------
# Converting reference builds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ds", DATASETS)
@pytest.mark.parametrize("name", [n for n, _ in INDEXES + OTHERS])
def test_convert_reference_build(name, ds):
    """A reference build carried across answers as the port's own build
    does, with the same bounds."""
    keys, q, lb = _cell(ds)
    b, rb = _pair(name, ds)
    ref_state = jax.tree.map(np.asarray, rb.state)
    c = convert.from_reference(name, ref_state, keys, rb.hyper, device="cpu")
    assert c.name == name
    assert c.hyper == rb.hyper and c.size_bytes == rb.size_bytes
    assert c.meta["max_err"] == b.meta["max_err"]
    qt = encode_keys(q, "cpu")
    for got, want in zip(c.lookup(c.state, qt), b.lookup(b.state, qt)):
        assert torch.equal(got, want)
    p = plan.lower(c, encode_keys(keys, "cpu"))
    np.testing.assert_array_equal(p.compile("torch")(qt).numpy(),
                                  _ref_rank(rb, keys, q))


def test_convert_unknown_index():
    with pytest.raises(ValueError, match="no converter"):
        convert.from_reference("lsm", {}, np.arange(4, dtype=np.uint64), {})


# ---------------------------------------------------------------------------
# uint64 arithmetic on int64 tensors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shift", [0, 1, 7, 48, 52, 63])
def test_radix_prefix_is_the_uint64_shift(shift):
    rng = np.random.default_rng(shift)
    r = 16
    kmin = np.uint64(rng.integers(0, 2**20, dtype=np.uint64))
    q = np.concatenate([rng.integers(0, 2**64 - 1, 4000, dtype=np.uint64,
                                     endpoint=True),
                        EXTREMES, [kmin - np.uint64(1), kmin,
                                   kmin + np.uint64(2**63)]])
    d = np.where(q > kmin, q - kmin, np.uint64(0))
    assert (d >= np.uint64(2**63)).any()
    want = np.minimum(d >> np.uint64(shift), np.uint64((1 << r) - 1))
    got = radix_prefix(encode_keys(q, "cpu"), encode_keys([kmin], "cpu")[0],
                       shift, r)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("name", ["rbs", "radix_spline"])
def test_radix_families_on_face_at_shift_48(name):
    """face's outliers near 2^64 give radix_bits=16 a shift of 48, with
    key differences above 2^63; extreme queries included."""
    keys, q, lb = _cell("face")
    r, shift = radix_spline.radix_shape(keys, 16)
    assert (r, shift) == (16, 48)
    assert int(keys[-1]) - int(keys[0]) >= 2**63
    b = base.REGISTRY[name](keys, radix_bits=16, device="cpu")
    rb = rbase.REGISTRY[name](keys, radix_bits=16)
    p = plan.lower(b, encode_keys(keys, "cpu"))
    for backend in ("torch", "cuda"):
        np.testing.assert_array_equal(
            p.compile(backend)(encode_keys(q, "cpu")).numpy(), lb)
    np.testing.assert_array_equal(_ref_rank(rb, keys, q), lb)


@pytest.mark.parametrize("name,hyper", [("rbs", dict(radix_bits=24)),
                                        ("radix_spline",
                                         dict(radix_bits=24, eps=2))])
def test_radix_families_unshifted_past_2_63(name, hyper):
    """A key range under 2^24 leaves no shift; queries 2^63 or more above
    the smallest key still lie past every bucket.  (The reference casts
    that difference to a negative int64 and answers wrongly here: ROADMAP
    queue C.)"""
    rng = np.random.default_rng(0)
    keys = np.unique(np.cumsum(rng.integers(1, 2**12, 5000) ** 2 // 4096
                               + 1).astype(np.uint64) + np.uint64(2**40))
    assert radix_spline.radix_shape(keys, 24)[1] == 0
    q = np.concatenate([keys[::7], keys[::11] + np.uint64(1), EXTREMES,
                        keys[:1] + np.uint64(2**63),
                        np.array([2**63 + 2**41, 2**64 - 2], np.uint64)])
    b = base.REGISTRY[name](keys, device="cpu", **hyper)
    p = plan.lower(b, encode_keys(keys, "cpu"))
    lb = np.searchsorted(keys, q)
    for backend in ("torch", "cuda"):
        np.testing.assert_array_equal(
            p.compile(backend)(encode_keys(q, "cpu")).numpy(), lb)
    assert validate.check_bounds(b, keys, q)["valid"]


@pytest.mark.parametrize("bits", [1, 13, 29, 40, 63])
def test_hash_multiply_wraps_like_uint64(bits):
    rng = np.random.default_rng(bits)
    k = np.concatenate([rng.integers(0, 2**64 - 1, 20000, dtype=np.uint64,
                                     endpoint=True), EXTREMES])
    assert (k >= np.uint64(2**63)).sum() > 1000
    enc = encode_keys(k, "cpu")
    with np.errstate(over="ignore"):
        prod = k * np.uint64(0x9E3779B97F4A7C15)
    got_prod = (enc ^ -(1 << 63)) * (0x9E3779B97F4A7C15 - (1 << 64))
    np.testing.assert_array_equal(got_prod.numpy().view(np.uint64), prod)
    np.testing.assert_array_equal(hashmap.hash_slots(enc, bits).numpy(),
                                  hashmap._hash_np(k, bits).astype(np.int64))


def test_robin_hash_refuses_a_table_its_packed_sort_cannot_order():
    keys = np.arange(1, 1001, dtype=np.uint64) * 3
    with pytest.raises(ValueError, match="slots"):
        hashmap.build(keys, load_factor=1e-15, device="cpu")
