"""The port's encoder-decoder (`repro_torch.models.encdec`, the
whisper-tiny backbone) against the reference's `repro.models.encdec`,
and its serving through `ServeEngine` against the reference engine.

Weights are the reference's ``init_params``, carried across by
`convert.encdec_from_reference`; inputs are numpy from a seed.
Tolerances are `tests/test_torch_models.py`'s: a layer to 1e-5 in
float32 and ``2e-2 + 2e-2 * |ref|`` in bf16; the port's decode against
its own forward in float32 to 1e-4 with every argmax equal; the engine's
greedy tokens exactly.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import encdec as RE
from repro.models import layers as RL
from repro.models import model as RM
from repro.serve import engine as rengine
from repro_torch import configs, convert
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve.engine import ServeEngine

ARCH = "whisper-tiny"
LAYER_TOL = {"float32": dict(atol=1e-5, rtol=0.0),
             "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


@functools.lru_cache(maxsize=None)
def _pair(dtype):
    rcfg = dataclasses.replace(rconfigs.get_smoke(ARCH), dtype=dtype)
    cfg = dataclasses.replace(configs.get_smoke(ARCH), dtype=dtype)
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    model = convert.encdec_from_reference(
        cfg, jax.tree.map(lambda a: np.asarray(a, np.float32), rp), "cpu")
    return rcfg, cfg, rp, model


def _x(shape, dtype, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, jnp.dtype(dtype)), torch.from_numpy(a).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_is_the_references(dtype):
    """bit for bit in bf16 (each step and constant rounded as
    ``jax.nn.gelu`` lowers); within 1e-6 in float32, where the two
    ``tanh``s differ in the last bit."""
    xr, xp = _x((4096,), dtype, seed=1)
    xr, xp = xr * 3, xp * 3
    got = L.gelu(xp).float().numpy()
    want = np.asarray(jax.jit(jax.nn.gelu)(xr), np.float32)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sq", [12, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention(dtype, sq):
    """One q block, and two of 512 (the reference's ``lax.map``)."""
    rcfg, cfg, rp, model = _pair(dtype)
    assert L._pick_chunk(sq, 512) == min(sq, 512)
    xr, xp = _x((2, sq, cfg.d_model), dtype, seed=2)
    er, ep = _x((2, cfg.encoder_seq, cfg.d_model), dtype, seed=3)
    rx = jax.tree.map(lambda a: a[0], rp["dec"]["xattn"])
    _close(L.cross_attention(cfg, model.dec[0].xattn, xp, ep),
           RL.cross_attention(rcfg, rx, xr, er), LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_equals_the_reference(dtype):
    """The bidirectional encoder stack over stub frames."""
    rcfg, cfg, rp, model = _pair(dtype)
    fr, fp = _x((2, cfg.encoder_seq, cfg.d_model), dtype, seed=4)
    with torch.inference_mode():
        got = E.encode(cfg, model, fp)
    _close(got, jax.jit(lambda p, f: RE.encode(rcfg, p, f))(rp, fr),
           LAYER_TOL[dtype])


def test_decode_equals_forward_in_float32():
    """Token by token from the encoder's states in the cache, the decode's
    logits equal the forward's at every position; no autograd graph is
    built."""
    _, cfg, _, model = _pair("float32")
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, (2, 10)))
    _, frames = _x((2, cfg.encoder_seq, cfg.d_model), "float32", seed=6)
    fwd, _ = M.forward(cfg, model, {"tokens": toks, "frames": frames})
    cache = M.init_cache(cfg, 2, 16, "cpu")
    with torch.no_grad():
        cache["enc_out"].copy_(E.encode(cfg, model, frames))
    steps = []
    for i in range(toks.shape[1]):
        logits, cache = M.decode_step(cfg, model, cache, toks[:, i:i + 1])
        assert not logits.requires_grad and not cache["k"].requires_grad
        steps.append(logits)
    dec = torch.stack(steps, 1)
    np.testing.assert_allclose(dec.numpy(), fwd.detach().numpy(), atol=1e-4,
                               rtol=0)
    assert torch.equal(dec[..., :cfg.vocab].argmax(-1),
                       fwd[..., :cfg.vocab].argmax(-1))
    assert cache["len"].tolist() == [10, 10]


def test_decode_reads_the_position_of_its_fill():
    """From a cache filled to 3 (zeros), the step's token takes
    ``dec_pos[3]`` and attends to rows 0..3, as the reference's."""
    rcfg, cfg, rp, model = _pair("float32")
    rcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          RM.cache_shapes(rcfg, 2, 4))
    rcache["len"] = jnp.asarray([3, 3], jnp.int32)
    cache = M.init_cache(cfg, 2, 4, "cpu")
    cache["len"].fill_(3)
    toks = np.array([[5], [6]], np.int32)
    assert E.DEC_POSITIONS == 32768 == model.dec_pos.shape[0]
    rl, _ = RM.decode_step(rcfg, rp, rcache, jnp.asarray(toks))
    pl, _ = M.decode_step(cfg, model, cache, torch.from_numpy(toks))
    _close(pl, rl, dict(atol=1e-4, rtol=0))


def test_engine_emits_the_reference_tokens():
    """`examples/serve_paged_kv.py`'s traffic (6 requests over 4 slots) on
    whisper-tiny-smoke in float32: the cache's encoder states stay zero
    in both engines."""
    rcfg, cfg, rp, model = _pair("float32")
    kw = dict(max_batch=4, max_seq=96, page_size=8)
    ref = rengine.ServeEngine(rcfg, rp, **kw)
    decode = ref._decode
    ref._decode = lambda *a: jax.block_until_ready(decode(*a))
    port = ServeEngine(cfg, model, device="cpu", **kw)
    assert set(port.cache) == {"k", "v", "enc_out", "len"}
    for eng in (ref, port):
        rng = np.random.default_rng(0)
        for _ in range(6):
            eng.submit(list(rng.integers(2, cfg.vocab, rng.integers(3, 9))),
                       max_new=6)
    want, got = ref.run(max_steps=64), port.run(max_steps=64)
    assert got == want and len(got) == 6
    np.testing.assert_array_equal(port.lens, ref.lens)
    np.testing.assert_array_equal(port.kv.table, ref.kv.table)
    assert not port.cache["enc_out"].any()


def test_encdec_from_reference_takes_every_leaf():
    rcfg, cfg, rp, model = _pair("bfloat16")
    pnp = jax.tree.map(lambda a: np.asarray(a, np.float32), rp)
    for name, p in model.named_parameters():
        want = convert._reference_leaf(model, name, pnp)
        assert tuple(p.shape) == want.shape and p.requires_grad
        assert p.dtype == (torch.float32 if "norm" in name
                           else torch.bfloat16), name
        np.testing.assert_array_equal(p.detach().float().numpy(), want)
    extra = dict(pnp, enc_extra={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="reference tree has"):
        convert.encdec_from_reference(cfg, extra, "cpu")


def test_full_whisper_tiny_on_the_meta_device_has_the_reference_count():
    """Every parameter tensor of the full config, by name, shape and type,
    against the reference's ``init_params`` traced without allocating."""
    cfg = configs.get(ARCH)
    model = M.init_params(cfg, device="meta")
    assert isinstance(model, E.EncDec)
    ref = jax.eval_shape(lambda: RM.init_params(rconfigs.get(ARCH),
                                                jax.random.PRNGKey(0)))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        keys = [k.key for k in path]
        if keys[0] in ("enc", "dec"):
            for i in range(leaf.shape[0]):
                want[".".join([keys[0], str(i), *keys[1:]])] = (
                    leaf.shape[1:], str(leaf.dtype))
        else:
            want[".".join(keys)] = (leaf.shape, str(leaf.dtype))
    got = {n: (tuple(p.shape), str(p.dtype).split(".")[1])
           for n, p in model.named_parameters()}
    assert got == want
    total = sum(p.numel() for p in model.parameters())
    assert total == sum(math.prod(a.shape) for a in jax.tree.leaves(ref))
    shapes = M.cache_shapes(cfg, 4, 128)
    assert tuple(shapes["k"].shape) == (4, 4, 128, 6, 64)
    assert tuple(shapes["enc_out"].shape) == (4, 1500, 384)
