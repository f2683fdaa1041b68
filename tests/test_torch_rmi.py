"""The port's f64 RMI builder and spec layer vs the reference."""
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
from repro.core import rmi as rrmi
from repro.data import sosd as rsosd
from repro_torch import convert
from repro_torch.core import base, plan, rmi, spec, validate
from repro_torch.kernels.common import encode_keys

DATASETS = ("amzn", "face", "osm", "wiki")
EXTREMES = np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 1], np.uint64)


@functools.lru_cache(maxsize=None)
def _cell(ds: str):
    keys = rsosd.generate(ds, 20_000, seed=3)
    q = np.concatenate([
        rsosd.make_queries(keys, 3_000, seed=5, present_frac=0.5),
        keys[:50], keys[-50:], keys[:50] - 1, keys[-50:] + 1, EXTREMES])
    return keys, q, np.searchsorted(keys, q)


@pytest.mark.parametrize("stage1", ["linear", "cubic", "minmax"])
@pytest.mark.parametrize("ds", DATASETS)
def test_bounds_valid_and_lb_matches_reference(ds, stage1):
    keys, q, lb = _cell(ds)
    b = rmi.build(keys, branching=1024, stage1=stage1, device="cpu")
    for qs in (q, keys):
        res = validate.check_bounds(b, keys, qs)
        assert res["valid"], (ds, stage1, res)
        assert res["max_width"] <= b.meta["max_err"]
    got = plan.lower(b, encode_keys(keys, "cpu")).compile("torch")(
        encode_keys(q, "cpu"))
    rb = rbase.REGISTRY["rmi"](keys, branching=1024, stage1=stage1)
    ref = rplan.lower(rb, jnp.asarray(keys)).compile(backend="jnp")(
        jnp.asarray(q))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), lb)
    assert b.hyper == rb.hyper
    assert b.size_bytes == rb.size_bytes


@pytest.mark.parametrize("last_mile", ["binary", "linear", "interpolation"])
def test_check_end_to_end(last_mile):
    keys, q, _ = _cell("osm")
    b = rmi.build(keys, branching=512, device="cpu")
    assert validate.check_end_to_end(b, keys, q, last_mile)["exact"]


@pytest.mark.parametrize("ds", DATASETS)
def test_rmi_from_reference(ds):
    """The reference's model carried across: LB ranks equal, stage-2
    predictions within 1 ulp (wherever the two stage-1s pick the same
    bucket), and every error entry at least what validity needs."""
    keys, q, lb = _cell(ds)
    B = 2048
    rb = rbase.REGISTRY["rmi"](keys, branching=B)
    ref_state = {k: np.asarray(v) for k, v in rb.state.items()}
    b = convert.rmi_from_reference(ref_state, keys, rb.hyper, device="cpu")
    for k in ("coeffs", "a2", "b2", "x0", "inv_range"):
        np.testing.assert_array_equal(b.state[k].numpy(), ref_state[k])
    p = plan.lower(b, encode_keys(keys, "cpu"))
    np.testing.assert_array_equal(
        p.compile("torch")(encode_keys(q, "cpu")).numpy(), lb)
    assert validate.check_bounds(b, keys, q)["valid"]

    scale = B / len(keys)
    qt = encode_keys(q, "cpu")
    u, bkt = rmi._stage1_bucket(b.state["coeffs"], b.state["x0"],
                                b.state["inv_range"], scale, B, qt)
    ru, rbkt = rrmi._stage1_bucket(rb.state["coeffs"], rb.state["x0"],
                                   rb.state["inv_range"], scale, B,
                                   jnp.asarray(q))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ru))
    same = bkt.numpy() == np.asarray(rbkt)
    assert same.mean() > 0.99, f"{(~same).sum()} buckets differ"
    pred = rmi._stage2_pred(b.state["a2"], b.state["b2"], u, bkt).numpy()
    rpred = np.asarray(rrmi._stage2_pred(rb.state["a2"], rb.state["b2"], ru,
                                         rbkt))
    ulp = np.spacing(np.abs(rpred))
    assert (np.abs(pred - rpred)[same] <= ulp[same]).all()

    # err covers every key's own |pred - rank| through the port's arithmetic
    ku, kb = rmi._stage1_bucket(b.state["coeffs"], b.state["x0"],
                                b.state["inv_range"], scale, B,
                                encode_keys(keys, "cpu"))
    gap = (rmi._stage2_pred(b.state["a2"], b.state["b2"], ku, kb)
           - torch.arange(len(keys), dtype=torch.float64)).abs().numpy()
    need = np.zeros(B)
    np.maximum.at(need, kb.numpy(), gap)
    assert (b.state["err"].numpy() >= np.ceil(np.minimum(need, len(keys) + 1))).all()


def test_schema_defaults_match_builder_signature():
    sig = inspect.signature(rmi.build)
    schema = spec.get_schema("rmi")
    for f in schema.fields:
        assert sig.parameters[f.name].default == f.default, f.name
    assert set(schema.field_map()) <= set(sig.parameters)
    ref_schema = rrmi.spec.get_schema("rmi")
    assert schema.defaults() == ref_schema.defaults()
    assert schema.ladder == ref_schema.ladder
    assert set(spec.SCHEMAS) == set(base.REGISTRY)


def test_spec_roundtrip_and_validation():
    specs = [spec.IndexSpec("rmi", dict(branching=512)),
             spec.IndexSpec("rmi", dict(stage1="cubic"), backend="cuda"),
             spec.IndexSpec("rmi", {}, last_mile="interpolation")]
    for s in specs:
        assert spec.IndexSpec.from_json(s.to_json()) == s
        v = s.validated()
        assert spec.IndexSpec.from_json(v.to_json()) == v
        assert set(v.hyper) == {"branching", "stage1"}
    for bad in (dict(branching=1), dict(branching=True),
                dict(stage1="quartic"), dict(fanout=4)):
        with pytest.raises(spec.SpecError):
            spec.IndexSpec("rmi", bad).validated()
    with pytest.raises(spec.SpecError):
        spec.IndexSpec("rmi", backend="pallas").validated()
    with pytest.raises(spec.SpecError):
        spec.IndexSpec("nope").validated()
    with pytest.raises(spec.SpecError):
        spec.IndexSpec.from_dict({"index": "rmi", "extra": 1})
    with pytest.raises(TypeError):
        spec.coerce(spec.IndexSpec("rmi"), hyper={"branching": 4})
    assert spec.coerce("rmi", {"branching": 64}, backend="cuda").backend == "cuda"
    assert spec.BACKENDS == plan.BACKENDS


def test_spec_build_is_the_direct_build():
    keys, q, _ = _cell("wiki")
    s = spec.IndexSpec("rmi", dict(branching=256), last_mile="linear")
    b = spec.build(s, keys, device="cpu")
    d = rmi.build(keys, branching=256, last_mile="linear", device="cpu")
    assert b.meta["spec"] == s.validated()
    assert b.hyper == d.hyper and b.meta["max_err"] == d.meta["max_err"]
    for k in d.state:
        assert torch.equal(b.state[k], d.state[k]), k
    assert plan.lower(b, encode_keys(keys, "cpu")).last_mile == "linear"


def test_base_helpers():
    assert base.nbytes(torch.zeros(3, dtype=torch.int64), np.zeros(2)) == 40
    pts = [(10, 5.0, "a"), (20, 4.0, "b"), (30, 6.0, "c"), (10, 6.0, "d")]
    assert base.pareto_front(pts) == rbase.pareto_front(pts)
    lo, hi = base.clip_bound(torch.tensor([-3, 4]), torch.tensor([2, 99]), 10)
    assert lo.tolist() == [0, 4] and hi.tolist() == [2, 10]
    assert base.get_index("rmi") is rmi.build
