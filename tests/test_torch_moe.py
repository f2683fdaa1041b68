"""The port's MoE FFN (`repro_torch.models.moe`) against the reference's
(`repro.models.moe`), both dispatches.

Weights are the reference's ``init_moe`` draws, carried across as numpy;
inputs are numpy from a seed.  Tolerances are `test_torch_models`'s: a
layer to 1e-5 in float32 and ``2e-2 + 2e-2 * |ref|`` in bf16.  The sorted
dispatch's ``keep`` mask is held bit for bit against the reference's own
arithmetic (`src/repro/models/moe.py:222-260`), which it does not return.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import moe as RMOE
from repro_torch import configs
from repro_torch.models import moe as MOE

LAYER_TOL = {"float32": dict(atol=1e-5, rtol=0.0),
             "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _cfgs(arch, **kw):
    return (dataclasses.replace(rconfigs.get_smoke(arch), **kw),
            dataclasses.replace(configs.get_smoke(arch), **kw))


def _params(rcfg, seed=0, zero_router=False):
    rp = RMOE.init_moe(rcfg, jax.random.PRNGKey(seed))
    if zero_router:
        rp["router"] = jnp.zeros_like(rp["router"])
    pp = {k: torch.from_numpy(np.array(np.asarray(v, np.float32))).to(
        getattr(torch, str(v.dtype))) for k, v in rp.items()}
    return rp, pp


def _x(shape, dtype, seed=1, scale=1.0, repeat=1):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)
    if repeat > 1:                    # runs of identical tokens
        a = np.repeat(a[:, :shape[1] // repeat], repeat, axis=1)
    return jnp.asarray(a, jnp.dtype(dtype)), torch.from_numpy(a).to(
        getattr(torch, dtype))


def _ref_keep(rcfg, rp, x2d):
    """The reference's ``keep`` for one group, by its own arithmetic."""
    t = x2d.shape[0]
    j = t * rcfg.top_k
    cap = max(8, ((int(rcfg.capacity_factor * t * rcfg.top_k
                       / rcfg.n_experts) + 7) // 8) * 8)
    _, top_i, _ = RMOE._router(rcfg, rp, x2d)
    eg = top_i.reshape(1, j)
    e_sorted = jnp.take_along_axis(eg, jnp.argsort(eg, axis=-1), axis=-1)
    seg_start = jax.vmap(lambda es: jnp.searchsorted(
        es, jnp.arange(rcfg.n_experts), side="left"))(e_sorted)
    pos = jnp.arange(j)[None] - jnp.take_along_axis(seg_start, e_sorted, -1)
    return np.asarray(pos < cap)


def _check(rcfg, cfg, rp, pp, xr, xp, dtype):
    rout, raux = RMOE.moe_ffn(rcfg, rp, xr)
    out, aux = MOE.moe_ffn(cfg, pp, xp)
    assert out.dtype == xp.dtype and aux.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(rout, np.float32), **LAYER_TOL[dtype])
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6, atol=1e-7)
    x2r = xr.reshape(-1, xr.shape[-1])
    _, top_i, _ = MOE._router(cfg, pp, xp.reshape(-1, xp.shape[-1]))
    _, rtop_i, _ = RMOE._router(rcfg, rp, x2r)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(rtop_i))
    keep = MOE.sorted_dispatch_plan(cfg, top_i)["keep"].numpy()
    np.testing.assert_array_equal(keep, _ref_keep(rcfg, rp, x2r))
    return keep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch", ["sorted", "dense"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x22b"])
def test_moe_ffn_equals_the_reference(arch, dispatch, dtype):
    rcfg, cfg = _cfgs(arch, dtype=dtype, moe_dispatch=dispatch)
    rp, pp = _params(rcfg)
    xr, xp = _x((2, 24, cfg.d_model), dtype)
    _check(rcfg, cfg, rp, pp, xr, xp, dtype)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x22b"])
def test_capacity_drops_equal_the_reference(arch):
    """512 tokens at a capacity factor of ~0: every expert keeps its 8
    earliest pairs (the stable sort's choice) and drops the rest."""
    rcfg, cfg = _cfgs(arch, dtype="float32", capacity_factor=1e-9)
    rp, pp = _params(rcfg)
    xr, xp = _x((1, 512, cfg.d_model), "float32")
    keep = _check(rcfg, cfg, rp, pp, xr, xp, "float32")
    assert MOE.capacity(cfg, 512) == 8
    assert keep.sum() == 8 * cfg.n_experts < keep.size


@pytest.mark.parametrize("zero_router", [False, True])
def test_tied_expert_ids_keep_the_reference_tokens(zero_router):
    """Runs of 8 identical tokens route identically, so each expert's
    segment holds long runs of one id and capacity cuts through them; with
    a zero router every probability ties and ``top_k`` must give the ties
    to the lowest expert ids, as ``lax.top_k`` does."""
    rcfg, cfg = _cfgs("deepseek-moe-16b", dtype="float32",
                      capacity_factor=0.25)
    rp, pp = _params(rcfg, zero_router=zero_router)
    xr, xp = _x((1, 256, cfg.d_model), "float32", repeat=8)
    keep = _check(rcfg, cfg, rp, pp, xr, xp, "float32")
    assert not keep.all()
    if zero_router:
        _, top_i, _ = MOE._router(cfg, pp, xp[0])
        assert (top_i == torch.arange(cfg.top_k)).all()


def test_dense_and_sorted_dispatch_agree_without_drops():
    """With room for every pair the two dispatches compute one function."""
    _, cfg = _cfgs("mixtral-8x22b", dtype="float32", capacity_factor=8.0)
    _, pp = _params(_cfgs("mixtral-8x22b", dtype="float32")[0])
    _, xp = _x((2, 24, cfg.d_model), "float32")
    sorted_out, a1 = MOE.moe_ffn(cfg, pp, xp)
    dense_out, a2 = MOE.moe_ffn(
        dataclasses.replace(cfg, moe_dispatch="dense"), pp, xp)
    np.testing.assert_allclose(sorted_out.numpy(), dense_out.numpy(),
                               atol=1e-5, rtol=0)
    assert float(a1) == float(a2)


@pytest.mark.parametrize("t", [1, 4, 63, 512])
def test_capacity_rounding_equals_the_reference(t):
    for arch in ("deepseek-moe-16b", "mixtral-8x22b"):
        for cf in (1e-9, 0.25, 1.25, 8.0):
            _, cfg = _cfgs(arch, capacity_factor=cf)
            want = int(cf * t * cfg.top_k / cfg.n_experts)
            assert MOE.capacity(cfg, t) == max(8, ((want + 7) // 8) * 8)


def test_moe_dispatch_demo_runs_on_the_cpu():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, os.path.join(root, "examples",
                                      "torch_moe_dispatch_demo.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")))
    assert out.returncode == 0, out.stderr
    assert "the window search equals lower_bound on every expert" in out.stdout
