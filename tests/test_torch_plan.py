"""The port's LookupPlan: every backend returns the reference's ranks.

RMI x dataset x last mile: the port's "torch" backend, its "cuda" backend
fused and unfused (plain versions on the CPU), the reference's jnp plan
and np.searchsorted must agree bit for bit.
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
from repro_torch.core import base, plan, rmi, search
from repro_torch.kernels.common import encode_keys

DATASETS = ("amzn", "face", "osm", "wiki")
LAST_MILES = ("binary", "linear", "interpolation")
N_KEYS, N_Q = 8_000, 512


@functools.lru_cache(maxsize=None)
def _cell(ds: str):
    keys = rsosd.generate(ds, N_KEYS, seed=3)
    q = rsosd.make_queries(keys, N_Q, seed=5, present_frac=0.7)
    return keys, q, np.searchsorted(keys, q)


@pytest.mark.parametrize("ds", DATASETS)
@pytest.mark.parametrize("branching", [512, 4096])
def test_backend_parity_matrix(branching, ds):
    keys, q, lb = _cell(ds)
    data, qt = encode_keys(keys, "cpu"), encode_keys(q, "cpu")
    b = rmi.build(keys, branching=branching, device="cpu")
    rb = rbase.REGISTRY["rmi"](keys, branching=branching)
    for lm in LAST_MILES:
        p = plan.lower(b, data, last_mile=lm)
        got_torch = p.compile("torch")(qt).numpy()
        got_fused = p.compile("cuda")(qt).numpy()
        got_unfused = p.compile("cuda", fused=False)(qt).numpy()
        ref = np.asarray(rplan.lower(rb, jnp.asarray(keys), last_mile=lm)
                         .compile(backend="jnp")(jnp.asarray(q)))
        np.testing.assert_array_equal(ref, lb)
        np.testing.assert_array_equal(got_torch, ref)
        np.testing.assert_array_equal(got_fused, ref)
        np.testing.assert_array_equal(got_unfused, ref)


def test_compile_cache_and_fused_state_reuse():
    keys, q, lb = _cell("osm")
    p = plan.lower(rmi.build(keys, branching=512, device="cpu"),
                   encode_keys(keys, "cpu"))
    assert p.compile("cuda") is p.compile("cuda", fused=True)
    assert p.compile("cuda") is not p.compile("cuda", fused=False)
    assert p.compile("torch") is p.compile("torch", fused=False)
    p.compile("cuda", fused=True)
    st = p._cache["_rmi_f32_state"]
    p.lb_expr("cuda", fused=True)
    assert p._cache["_rmi_f32_state"] is st
    assert st.n == N_KEYS and st.branching == 512


def test_lowering_contract():
    keys, q, lb = _cell("wiki")
    b = rmi.build(keys, branching=256, last_mile="interpolation", device="cpu")
    p = plan.lower(b, encode_keys(keys, "cpu"))
    assert p.last_mile == "interpolation" and p.n == N_KEYS
    assert p.bounds.max_err == b.meta["max_err"]
    assert p.fused is plan.FUSED_LOWERERS["rmi"]
    assert plan.lower(b, p.data, last_mile="binary").last_mile == "binary"
    with pytest.raises(ValueError, match="backend"):
        p.compile("pallas")
    shim = search.fused_lookup_fn(b, p.data, backend="cuda")
    np.testing.assert_array_equal(shim(encode_keys(q, "cpu")).numpy(), lb)


def test_plan_without_fused_executor():
    """An index with no fused executor: cuda runs its bounds through the
    bounded-search wrapper; fused=True is refused."""
    keys, q, lb = _cell("amzn")
    r = rmi.build(keys, branching=1024, device="cpu")
    other = base.IndexBuild(name="rmi_copy", state=r.state, lookup=r.lookup,
                            size_bytes=r.size_bytes, hyper={}, meta=r.meta)
    p = plan.lower(other, encode_keys(keys, "cpu"))
    assert p.fused is None
    np.testing.assert_array_equal(
        p.compile("cuda")(encode_keys(q, "cpu")).numpy(), lb)
    with pytest.raises(ValueError, match="no fused"):
        p.lb_expr("cuda", fused=True)


@pytest.mark.parametrize("ds", DATASETS)
def test_unfused_cuda_plan_passes_hi_to_the_search(ds, monkeypatch):
    """fused=False hands the plan's own (lo, hi) to the bounded-search
    wrapper, so each query searches its own window, and still equals
    the torch backend."""
    from repro_torch.kernels.bounded_search import ops as bops

    keys, q, lb = _cell(ds)
    data, qt = encode_keys(keys, "cpu"), encode_keys(q, "cpu")
    p = plan.lower(rmi.build(keys, branching=1024, device="cpu"), data)
    seen = []

    def spy(data, queries, lo, max_width, hi=None):
        seen.append((lo, hi, max_width))
        return bops.lower_bound_windows_plain(data, queries, lo, max_width,
                                              hi)

    monkeypatch.setattr(bops, "lower_bound_windows", spy)
    got = p.compile("cuda", fused=False)(qt)
    assert len(seen) == 1
    lo, hi, width = seen[0]
    plo, phi = p.bounds.predict(p.bounds.state, qt)
    assert hi is not None and torch.equal(hi, phi) and torch.equal(lo, plo)
    assert width == p.bounds.max_err
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), p.compile("torch")(qt).numpy())
    np.testing.assert_array_equal(got.numpy(), lb)


def test_fused_cuda_plan_returns_int64_ranks_from_one_call(monkeypatch):
    """The fused RMI executor is one call of rmi_lookup, whose ranks are
    already the int64 the plan returns (no cast after it)."""
    from repro_torch.kernels.rmi_lookup import ops as rops

    keys, q, lb = _cell("face")
    qt = encode_keys(q, "cpu")
    p = plan.lower(rmi.build(keys, branching=512, device="cpu"),
                   encode_keys(keys, "cpu"))
    calls = []
    real = rops.rmi_lookup

    def spy(st, data, queries):
        out = real(st, data, queries)
        calls.append(out)
        return out

    monkeypatch.setattr(rops, "rmi_lookup", spy)
    got = p.compile("cuda")(qt)
    assert len(calls) == 1 and got is calls[0]
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), lb)
