"""The port's Mamba-2 SSD layer (`repro_torch.models.mamba2`) against the
reference's (`repro.models.mamba2`).

Weights are the reference's ``init_mamba`` draws (``A_log``, ``D`` and
``dt_bias`` replaced by random values so that the decay and skip are not
trivial), carried across as numpy; inputs are numpy from a seed.
Tolerances are `test_torch_models`'s: a layer to 1e-5 in float32 and
``2e-2 + 2e-2 * |ref|`` in bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import mamba2 as RS
from repro_torch import configs
from repro_torch.models import mamba2 as S

LAYER_TOL = {"float32": dict(atol=1e-5, rtol=0.0),
             "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _cfgs(arch="mamba2-2.7b", **kw):
    return (dataclasses.replace(rconfigs.get_smoke(arch), **kw),
            dataclasses.replace(configs.get_smoke(arch), **kw))


def _arr(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(a, dtype="float32"):
    return jnp.asarray(a, jnp.dtype(dtype)), torch.from_numpy(a).to(
        getattr(torch, dtype))


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def _params(rcfg):
    rp = RS.init_mamba(rcfg, jax.random.PRNGKey(0))
    nh = rcfg.ssm_heads
    rp["A_log"] = jnp.asarray(_arr((nh,), 7, 0.5))
    rp["D"] = jnp.asarray(_arr((nh,), 8))
    rp["dt_bias"] = jnp.asarray(_arr((nh,), 9, 0.5))
    pp = {k: torch.from_numpy(np.array(np.asarray(v, np.float32))).to(
        getattr(torch, str(v.dtype))) for k, v in rp.items()}
    return rp, pp


@pytest.mark.parametrize("s,chunk", [(32, 8), (64, 16), (48, 16), (16, 32),
                                     (128, 32), (8, 8)])
def test_ssd_chunked_equals_the_reference(s, chunk):
    rcfg, cfg = _cfgs(ssm_chunk=chunk)
    b, h, p, n = 2, 4, 8, 16
    xr, xp = _both(_arr((b, s, h, p), 0, 0.5))
    br, bp = _both(_arr((b, s, n), 1, 0.5))
    cr, cp = _both(_arr((b, s, n), 2, 0.5))
    dt = np.log1p(np.exp(_arr((b, s, h), 3)))
    dr, dp = _both(dt)
    ar, ap = _both(_arr((h,), 4, 0.5))
    Dr, Dp = _both(_arr((h,), 5))
    got = S.ssd_chunked(cfg, xp, bp, cp, dp, ap, Dp)
    assert got.dtype == torch.float32
    _close(got, RS.ssd_chunked(rcfg, xr, br, cr, dr, ar, Dr),
           LAYER_TOL["float32"])


def test_ssd_chunked_needs_whole_chunks():
    _, cfg = _cfgs(ssm_chunk=16)
    z = torch.zeros((1, 24, 2, 4))
    with pytest.raises(AssertionError, match="ssm_chunk"):
        S.ssd_chunked(cfg, z, torch.zeros((1, 24, 8)), torch.zeros((1, 24, 8)),
                      torch.zeros((1, 24, 2)), torch.zeros(2), torch.zeros(2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_with_and_without_state(dtype):
    xr, xp = _both(_arr((2, 9, 40), 0), dtype)
    wr, wp = _both(_arr((4, 40), 1, 0.1), dtype)
    _close(S._causal_conv(xp, wp), RS._causal_conv(xr, wr), LAYER_TOL[dtype])
    sr, sp = _both(_arr((2, 3, 40), 2), dtype)
    out, st = S._causal_conv(xp[:, :1], wp, sp)
    rout, rst = RS._causal_conv(xr[:, :1], wr, sr)
    _close(out, rout, LAYER_TOL[dtype])
    _close(st, rst, {"atol": 0.0, "rtol": 0.0})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_mamba_layer_equals_the_reference(arch, dtype):
    rcfg, cfg = _cfgs(arch, dtype=dtype)
    rp, pp = _params(rcfg)
    xr, xp = _both(_arr((2, 64, cfg.d_model), 3), dtype)
    _close(S.mamba_layer(cfg, pp, xp), RS.mamba_layer(rcfg, rp, xr),
           LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chained_mamba_decode_equals_the_layer_and_the_reference(dtype):
    """Token by token from a zero state, the decode equals the chunked
    layer (the port's own, f32) and the reference's decode (each step)."""
    rcfg, cfg = _cfgs(dtype=dtype)
    rp, pp = _params(rcfg)
    s = 24
    xr, xp = _both(_arr((2, s, cfg.d_model), 4), dtype)
    dt = getattr(torch, dtype)
    ssm = torch.zeros((2, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim))
    conv = torch.zeros((2, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                       dtype=dt)
    rssm, rconv = jnp.asarray(ssm.numpy()), jnp.asarray(conv.float().numpy(),
                                                        jnp.dtype(dtype))
    outs = []
    for i in range(s):
        y, ssm, conv = S.mamba_decode(cfg, pp, xp[:, i:i + 1], ssm, conv)
        ry, rssm, rconv = RS.mamba_decode(rcfg, rp, xr[:, i:i + 1], rssm,
                                          rconv)
        _close(y, ry, LAYER_TOL[dtype])
        _close(ssm, rssm, LAYER_TOL[dtype])
        assert ssm.dtype == torch.float32 and conv.dtype == dt
        outs.append(y)
    if dtype == "float32":
        np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                                   S.mamba_layer(cfg, pp, xp).numpy(),
                                   atol=1e-5, rtol=0)
