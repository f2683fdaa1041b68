"""The port's decoder (`repro_torch.models`, `repro_torch.configs`)
against the reference (`repro.models`, `repro.configs`).

The same inputs, made with numpy from a seed, go through both; weights
are the reference's ``init_params``, carried across by
`convert.decoder_from_reference`.  Tolerances:

- float32: 1e-5 absolute for a layer, 1e-4 for logits (the two
  frameworks sum matrix products in other orders; measured ~5e-6).
- bfloat16: ``|port - ref| <= 2e-2 + 2e-2 * |ref|`` for a layer and
  ``5e-2 + 2e-2 * |ref|`` through the whole stack (logits, and the
  cache after chained decode steps): a few
  bf16 ulps (2^-8 relative), since the two frameworks round to bf16 at
  other places (after a product, inside an activation).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import transformer as RT
from repro_torch import configs, convert
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import transformer as T

DENSE = ["granite-3-2b", "starcoder2-3b", "qwen1.5-32b",
         "command-r-plus-104b", "chameleon-34b"]
NEW = ["mamba2-2.7b", "jamba-1.5-large-398b", "deepseek-moe-16b",
       "mixtral-8x22b"]
DECODERS = DENSE + NEW
DTYPES = ["float32", "bfloat16"]
LAYER_TOL = {"float32": dict(atol=1e-5, rtol=0.0),
             "bfloat16": dict(atol=2e-2, rtol=2e-2)}
LOGITS_TOL = {"float32": dict(atol=1e-4, rtol=0.0),
              "bfloat16": dict(atol=5e-2, rtol=2e-2)}


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


@functools.lru_cache(maxsize=None)
def _weights(arch, dtype):
    rcfg = dataclasses.replace(rconfigs.get_smoke(arch), dtype=dtype)
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=dtype)
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    pnp = jax.tree.map(lambda a: np.asarray(a, np.float32), rp)
    return rp, convert.decoder_from_reference(cfg, pnp, "cpu")


def _pair(arch, dtype, **attn):
    """(reference cfg, port cfg, reference params, port decoder); ``attn``
    changes attention fields, which the weights do not depend on."""
    rp, model = _weights(arch, dtype)
    return (dataclasses.replace(rconfigs.get_smoke(arch), dtype=dtype, **attn),
            dataclasses.replace(configs.get_smoke(arch), dtype=dtype, **attn),
            rp, model)


def _x(shape, dtype, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, jnp.dtype(dtype)), torch.from_numpy(a).to(
        getattr(torch, dtype))


def _block0(rp, part):
    return jax.tree.map(lambda a: a[0], rp["blocks"]["sub0"][part])


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list(rconfigs.ARCHS))
def test_config_and_smoke_config_equal_the_reference(arch):
    for get in ("get", "get_smoke"):
        ref, port = getattr(rconfigs, get)(arch), getattr(configs, get)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), get
        for prop in ("hd", "vocab_padded", "d_inner", "ssm_heads",
                     "moe_hidden"):
            assert getattr(port, prop) == getattr(ref, prop), (get, prop)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        for i in range(port.n_layers):
            assert port.is_moe_layer(i) == ref.is_moe_layer(i)
            assert port.is_attn_layer(i) == ref.is_attn_layer(i)


def test_registry_tables_equal_the_reference():
    assert list(configs.ARCHS) == list(rconfigs.ARCHS)
    assert configs.SHAPES == rconfigs.SHAPES
    assert configs.SKIPS == rconfigs.SKIPS


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(kind, dtype):
    xr, xp = _x((2, 7, 96), dtype)
    rng = np.random.default_rng(1)
    scale = rng.standard_normal(96).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    cfg = dataclasses.replace(configs.get_smoke("granite-3-2b"), norm=kind)
    rcfg = dataclasses.replace(rconfigs.get_smoke("granite-3-2b"), norm=kind)
    p = {"scale": torch.from_numpy(scale)}
    rp = {"scale": jnp.asarray(scale)}
    if kind == "layernorm":
        p["bias"], rp["bias"] = torch.from_numpy(bias), jnp.asarray(bias)
    _close(L.norm(cfg, xp, p), RL.norm(rcfg, xr, rp), LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta", [10000.0, 999999.4, 75000000.0])
def test_rope_rotates_concatenated_halves(theta, dtype):
    xr, xp = _x((2, 9, 3, 32), dtype)
    pos = np.random.default_rng(2).integers(0, 5000, (2, 9))
    _close(L.rope(xp, torch.from_numpy(pos), theta),
           RL.rope(xr, jnp.asarray(pos), theta), LAYER_TOL[dtype])


@pytest.mark.parametrize("s_len,target", [(64, 64), (96, 64), (256, 128),
                                          (384, 128), (1500, 512),
                                          (1000, 200)])
def test_pick_chunk(s_len, target):
    assert L._pick_chunk(s_len, target) == RL._pick_chunk(s_len, target)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_attention_prefill(arch, dtype):
    rcfg, cfg, rp, model = _pair(arch, dtype)
    xr, xp = _x((2, 40, cfg.d_model), dtype, seed=3)
    pos = np.tile(np.arange(40), (2, 1))
    _close(L.attention(cfg, model.blocks[0].attn, xp, torch.from_numpy(pos)),
           RL.attention(rcfg, _block0(rp, "attn"), xr, jnp.asarray(pos)),
           LAYER_TOL[dtype])


@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("arch", ["granite-3-2b", "starcoder2-3b"])
def test_attention_online_softmax_over_kv_chunks(arch, window):
    """Three KV chunks of 128 (and a sliding window that masks whole
    chunks for late queries), float32."""
    rcfg, cfg, rp, model = _pair(arch, "float32", attn_chunk=128,
                                 attn_window=window)
    assert L._pick_chunk(384, cfg.attn_chunk) == 128
    xr, xp = _x((1, 384, cfg.d_model), "float32", seed=4)
    pos = np.arange(384)[None]
    _close(L.attention(cfg, model.blocks[0].attn, xp, torch.from_numpy(pos)),
           RL.attention(rcfg, _block0(rp, "attn"), xr, jnp.asarray(pos)),
           LAYER_TOL["float32"])


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_attention_kv_decode_step(arch, dtype, window):
    """Rows at 0, mid-cache, the last position and ``len == s_max`` (the
    reference drops that write; the port must too)."""
    rcfg, cfg, rp, model = _pair(arch, dtype, attn_window=window)
    s_max = 8
    lens = np.array([0, 5, 7, 8], np.int32)
    xr, xp = _x((4, 1, cfg.d_model), dtype, seed=5)
    kv_shape = (4, s_max, cfg.n_kv_heads, cfg.hd)
    kr, kp = _x(kv_shape, dtype, seed=6)
    vr, vp = _x(kv_shape, dtype, seed=7)
    y, kr2, vr2 = RL.attention_kv(rcfg, _block0(rp, "attn"), xr,
                                  jnp.asarray(lens[:, None]), kr, vr,
                                  jnp.asarray(lens))
    yp, kp2, vp2 = L.attention_kv(cfg, model.blocks[0].attn, xp,
                                  torch.from_numpy(lens[:, None]), kp, vp,
                                  torch.from_numpy(lens))
    _close(yp, y, LAYER_TOL[dtype])
    _close(kp2, kr2, LAYER_TOL[dtype])
    _close(vp2, vr2, LAYER_TOL[dtype])
    # the full row kept every old value
    np.testing.assert_array_equal(kp2[3].float().numpy(),
                                  np.asarray(kr[3], np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_mlp(arch, dtype):
    rcfg, cfg, rp, model = _pair(arch, dtype)
    xr, xp = _x((2, 5, cfg.d_model), dtype, seed=8)
    _close(L.mlp(cfg, model.blocks[0].mlp, xp),
           RL.mlp(rcfg, _block0(rp, "mlp"), xr), LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_embed_and_unembed(arch, dtype):
    rcfg, cfg, rp, model = _pair(arch, dtype)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_padded, (2, 6))
    _close(L.embed(cfg, model.embed, torch.from_numpy(toks)),
           RL.embed(rcfg, rp["embed"], jnp.asarray(toks)), LAYER_TOL[dtype])
    xr, xp = _x((2, 6, cfg.d_model), dtype, seed=10)
    _close(L.unembed(cfg, model.embed, xp),
           RL.unembed(rcfg, rp["embed"], xr), LAYER_TOL[dtype])


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_forward_loss_and_chained_decode_steps(arch, dtype):
    rcfg, cfg, rp, model = _pair(arch, dtype)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(-1, cfg.vocab, (2, 16)).astype(np.int32)
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    pb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels)}
    rlogits, _ = jax.jit(lambda p, b: RM.forward(rcfg, p, b))(rp, rb)
    logits, aux = M.forward(cfg, model, pb)
    assert logits.shape == (2, 16, cfg.vocab_padded)
    assert logits.dtype == getattr(torch, dtype) and float(aux) == 0.0
    _close(logits, rlogits, LOGITS_TOL[dtype])
    rloss = jax.jit(lambda p, b: RM.loss_fn(rcfg, p, b))(rp, rb)
    _close(M.loss_fn(cfg, model, pb), rloss, LOGITS_TOL[dtype])

    rcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          RM.cache_shapes(rcfg, 2, 24))
    cache = M.init_cache(cfg, 2, 24, "cpu")
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[1])
            for k, t in cache["blocks"]["sub0"].items()} == {
        k: (s.shape, str(s.dtype))
        for k, s in RM.cache_shapes(rcfg, 2, 24)["blocks"]["sub0"].items()}
    step = jax.jit(lambda p, c, t: RM.decode_step(rcfg, p, c, t))
    for i in range(3):
        t = toks[:, i:i + 1]
        rl, rcache = step(rp, rcache, jnp.asarray(t))
        pl, cache = M.decode_step(cfg, model, cache, torch.from_numpy(t))
        _close(pl, rl, LOGITS_TOL[dtype])
        np.testing.assert_array_equal(cache["len"].numpy(),
                                      np.asarray(rcache["len"]))
        for k in ("k", "v"):
            _close(cache["blocks"]["sub0"][k],
                   rcache["blocks"]["sub0"][k], LOGITS_TOL[dtype])
    assert cache["len"].dtype == torch.int32


@pytest.mark.parametrize("dtype", DTYPES)
def test_whisper_tiny_forward_loss_and_chained_decode_steps(dtype):
    """The encdec family whole (`repro_torch.models.encdec`): logits and
    loss on stub frames, then two decode steps from the reference
    engine's cache (encoder states zero), logits and KV each step."""
    rcfg = dataclasses.replace(rconfigs.get_smoke("whisper-tiny"),
                               dtype=dtype)
    cfg = dataclasses.replace(configs.get_smoke("whisper-tiny"), dtype=dtype)
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    model = convert.encdec_from_reference(
        cfg, jax.tree.map(lambda a: np.asarray(a, np.float32), rp), "cpu")
    rng = np.random.default_rng(21)
    toks = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    labels = rng.integers(-1, cfg.vocab, (2, 12)).astype(np.int32)
    fr, fp = _x((2, cfg.encoder_seq, cfg.d_model), dtype, seed=22)
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "frames": fr}
    pb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels), "frames": fp}
    with torch.inference_mode():
        logits, aux = M.forward(cfg, model, pb)
        loss = M.loss_fn(cfg, model, pb)
    _close(logits, jax.jit(lambda p, b: RM.forward(rcfg, p, b)[0])(rp, rb),
           LOGITS_TOL[dtype])
    assert float(aux) == 0.0
    _close(loss, jax.jit(lambda p, b: RM.loss_fn(rcfg, p, b))(rp, rb),
           LOGITS_TOL[dtype])

    rcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          RM.cache_shapes(rcfg, 2, 16))
    cache = M.init_cache(cfg, 2, 16, "cpu")
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[1])
            for k, t in cache.items()} == {
        k: (s.shape, str(s.dtype))
        for k, s in RM.cache_shapes(rcfg, 2, 16).items()}
    step = jax.jit(lambda p, c, t: RM.decode_step(rcfg, p, c, t))
    for i in range(2):
        t = toks[:, i:i + 1]
        rl, rcache = step(rp, rcache, jnp.asarray(t))
        pl, cache = M.decode_step(cfg, model, cache, torch.from_numpy(t))
        assert not pl.requires_grad
        _close(pl, rl, LOGITS_TOL[dtype])
        np.testing.assert_array_equal(cache["len"].numpy(),
                                      np.asarray(rcache["len"]))
        for k in ("k", "v"):
            _close(cache[k], rcache[k], LOGITS_TOL[dtype])


@pytest.mark.parametrize("arch", DECODERS)
def test_stack_plan_equals_the_reference(arch):
    for get in ("get", "get_smoke"):
        assert (T.stack_plan(getattr(configs, get)(arch))
                == RT.stack_plan(getattr(rconfigs, get)(arch)))


def _cache_close(cache, rcache, tol):
    """Every leaf of the port's cache against the reference's."""
    assert cache.keys() == rcache.keys()
    for name, sub in rcache.items():
        if name == "len":
            np.testing.assert_array_equal(cache["len"].numpy(),
                                          np.asarray(sub))
            continue
        subs = sub.items() if name == "blocks" else [(None, sub)]
        for j, leaves in subs:
            mine = cache[name][j] if j else cache[name]
            assert mine.keys() == leaves.keys()
            for k, v in leaves.items():
                assert tuple(mine[k].shape) == v.shape
                assert str(mine[k].dtype).split(".")[1] == str(v.dtype)
                _close(mine[k], v, tol)


@pytest.mark.parametrize("arch", NEW)
def test_new_families_forward_loss_and_chained_decode_steps(arch):
    """float32, the whole stack: logits, aux, loss + aux, and every cache
    leaf (KV, SSM state, conv history, the prologue's) after each of 4
    chained decode steps.  bf16 is held block by block (below): through
    the whole stack an ulp can flip a top-k routing choice, and the
    reference's own jitted and eager forwards of deepseek-moe-16b-smoke
    differ by ~0.6 in bf16 for that reason."""
    rcfg, cfg, rp, model = _pair(arch, "float32")
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(-1, cfg.vocab, (2, 16)).astype(np.int32)
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    pb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels)}
    rlogits, raux = jax.jit(lambda p, b: RM.forward(rcfg, p, b))(rp, rb)
    with torch.inference_mode():
        logits, aux = M.forward(cfg, model, pb)
        loss = M.loss_fn(cfg, model, pb)
    _close(logits, rlogits, LOGITS_TOL["float32"])
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5, atol=1e-7)
    assert (float(aux) > 0) == bool(cfg.n_experts)
    rloss = jax.jit(lambda p, b: RM.loss_fn(rcfg, p, b))(rp, rb)
    _close(loss, rloss, LOGITS_TOL["float32"])

    rcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          RM.cache_shapes(rcfg, 2, 24))
    cache = M.init_cache(cfg, 2, 24, "cpu")
    step = jax.jit(lambda p, c, t: RM.decode_step(rcfg, p, c, t))
    for i in range(4):
        t = toks[:, i:i + 1]
        rl, rcache = step(rp, rcache, jnp.asarray(t))
        with torch.inference_mode():
            pl, cache = M.decode_step(cfg, model, cache, torch.from_numpy(t))
        _close(pl, rl, LOGITS_TOL["float32"])
        _cache_close(cache, rcache, LOGITS_TOL["float32"])


def _rblocks(rcfg, rp):
    """The reference's blocks in the port's order: (params, mixer, ffn)."""
    pro, unit, n_scan = RT.stack_plan(rcfg)
    out = [(rp[f"pro{i}"], m, f) for i, (m, f, _) in enumerate(pro)]
    for i in range(n_scan):
        for j, (m, f, _) in enumerate(unit):
            out.append((jax.tree.map(lambda a: a[i], rp["blocks"][f"sub{j}"]),
                        m, f))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", NEW)
def test_every_block_forward_and_decode_step(arch, dtype):
    """Each block of the stack on the same input as the reference's
    ``apply_block`` (aux too) and ``apply_block_decode`` (with its cache
    rows at mixed fills), at the layer tolerance."""
    rcfg, cfg, rp, model = _pair(arch, dtype)
    blocks = [*model.pro, *model.blocks]
    rblocks = _rblocks(rcfg, rp)
    assert [(b.mixer, b.ffn) for b in blocks] == [(m, f) for _, m, f in
                                                  rblocks]
    xr, xp = _x((2, 16, cfg.d_model), dtype, seed=12)
    pos = np.tile(np.arange(16), (2, 1))
    dr, dp = _x((2, 1, cfg.d_model), dtype, seed=13)
    lens = np.array([3, 7], np.int32)
    for n, (blk, (rpb, mixer, ffn)) in enumerate(zip(blocks, rblocks)):
        ry, raux = RT.apply_block(rcfg, rpb, xr, jnp.asarray(pos),
                                  jnp.zeros((), jnp.float32), mixer, ffn)
        with torch.inference_mode():
            y, aux = blk(cfg, xp, torch.from_numpy(pos),
                         torch.zeros((), dtype=torch.float32))
        _close(y, ry, LAYER_TOL[dtype])
        np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5,
                                   atol=1e-7)
        if mixer == "attn":
            kv = (2, 8, cfg.n_kv_heads, cfg.hd)
            c = dict(zip("kv", (_x(kv, dtype, seed=14 + i) for i in range(2))))
        else:
            c = {"ssm": _x((2, cfg.ssm_heads, cfg.ssm_state,
                            cfg.ssm_head_dim), "float32", seed=16),
                 "conv": _x((2, cfg.ssm_conv - 1,
                             cfg.d_inner + 2 * cfg.ssm_state), dtype, seed=17)}
        rc = {k: v[0] for k, v in c.items()}
        rc["len"] = jnp.asarray(lens)
        ry, rc = RT.apply_block_decode(rcfg, rpb, dr, jnp.asarray(lens[:, None]),
                                       rc, mixer, ffn)
        # the port's own copies: a tensor from `torch.from_numpy` shares
        # the numpy buffer, which `jnp.asarray` may alias on the CPU while
        # the reference's dispatched step still reads it
        pc = {k: v[1].clone() for k, v in c.items()}
        with torch.inference_mode():
            y = blk.decode(cfg, dp, torch.from_numpy(lens[:, None]), pc,
                           torch.from_numpy(lens))
        _close(y, ry, LAYER_TOL[dtype])
        for k in pc:
            _close(pc[k], rc[k], LAYER_TOL[dtype])
        xr, xp = _x((2, 16, cfg.d_model), dtype, seed=20 + n)


def test_full_granite_on_the_meta_device_has_the_reference_count():
    cfg = configs.get("granite-3-2b")
    model = M.init_params(cfg, device="meta")
    norms = sum(p.numel() for n, p in model.named_parameters()
                if "norm" in n)
    weights = sum(p.numel() for n, p in model.named_parameters()
                  if "norm" not in n)
    # param_count() counts the matrices, not the norm scales
    assert weights == cfg.param_count() == 2_533_883_904
    assert norms == (2 * cfg.n_layers + 1) * cfg.d_model
    assert {p.dtype for n, p in model.named_parameters()
            if "norm" not in n} == {torch.bfloat16}
    shapes = M.cache_shapes(cfg, 4, 128)
    assert tuple(shapes["blocks"]["sub0"]["k"].shape) == (40, 4, 128, 8, 64)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-2.7b"])
def test_full_config_on_the_meta_device_has_the_reference_count(arch):
    """Every parameter tensor of the full config, by name, shape and
    type, against the reference's ``init_params`` traced without
    allocating."""
    cfg = configs.get(arch)
    model = M.init_params(cfg, device="meta")
    ref = jax.eval_shape(lambda: RM.init_params(rconfigs.get(arch),
                                                jax.random.PRNGKey(0)))
    pro, unit, n_scan = T.stack_plan(cfg)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        keys = [k.key for k in path]
        if keys[0] == "blocks":
            j = int(keys[1][3:])
            for i in range(n_scan):
                want[".".join(["blocks", str(i * len(unit) + j), *keys[2:]])] = (
                    leaf.shape[1:], str(leaf.dtype))
        elif keys[0].startswith("pro"):
            want[".".join(["pro", keys[0][3:], *keys[1:]])] = (
                leaf.shape, str(leaf.dtype))
        else:
            want[".".join(keys)] = (leaf.shape, str(leaf.dtype))
    got = {n: (tuple(p.shape), str(p.dtype).split(".")[1])
           for n, p in model.named_parameters()}
    assert got == want
    total = sum(p.numel() for p in model.parameters())
    assert total == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(ref))
    assert total == {"deepseek-moe-16b": 16_375_728_128,
                     "mamba2-2.7b": 2_702_624_256}[arch]


@pytest.mark.parametrize("arch", NEW)
def test_decoder_from_reference_takes_every_leaf_of_the_new_trees(arch):
    rcfg, cfg, rp, model = _pair(arch, "float32")
    pnp = jax.tree.map(lambda a: np.asarray(a, np.float32), rp)
    for name, p in model.named_parameters():
        assert p.dtype == (torch.float32 if p.dtype == torch.float32
                           else getattr(torch, cfg.dtype))
    extra = dict(pnp, pro9={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="values"):
        convert.decoder_from_reference(cfg, extra, "cpu")
    missing = jax.tree.map(lambda a: a, pnp)
    sub = next(iter(missing["blocks"].values()))
    sub.pop(next(iter(sub)))
    with pytest.raises(KeyError):
        convert.decoder_from_reference(cfg, missing, "cpu")


def test_decoder_from_reference_takes_every_leaf():
    rcfg, cfg, rp, _ = _pair("granite-3-2b", "float32")
    pnp = jax.tree.map(lambda a: np.asarray(a, np.float32), rp)
    pnp["extra"] = {"w": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="values"):
        convert.decoder_from_reference(cfg, pnp, "cpu")
    assert T.stack_plan(cfg) == ([], [("attn", "dense", 0)], cfg.n_layers)
