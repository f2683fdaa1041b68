"""The decoder stack for every decoder family, as an ``nn.Module``.

The reference (`repro.models.transformer`) composes every family from one
block, a mixer (attention or SSD) and an FFN (dense, MoE or none), and
stacks them by a plan (`stack_plan`): a prologue of unrolled blocks, then
a unit of blocks scanned ``n_scan`` times.

  dense, vlm        L identical (attn, dense) blocks
  moe (mixtral)     L identical (attn, moe) blocks
  moe (deepseek)    layer 0 unrolled (attn, wide dense), then (attn, moe)
  ssm (mamba2)      L (ssd, none) blocks
  hybrid (jamba)    L/period units of [attn, ssd x (period-1)], MoE on
                    the layers `is_moe_layer` names

Here each block is a `Block`, the prologue is ``pro[i]`` and the scanned
units are flattened, in layer order, into ``blocks``: block ``i * U + j``
is the reference's ``params["blocks"][f"sub{j}"]`` at layer-axis index
``i`` for a unit of ``U`` blocks (`repro_torch.convert.
decoder_from_reference`).  The scan is a loop, each unit of it
recomputed in the backward pass as ``cfg.remat`` asks (`remat`).  The
encdec family is `repro_torch.models.encdec`.  Weights are made with an
explicit ``torch.Generator`` at the reference's scales and are trainable;
a decode step builds no autograd graph.

The decode cache mirrors the reference's tree: ``{"blocks": {"sub{j}":
...}, "pro{i}": ..., "len"}``, where an attention block holds ``k``/``v``
``[B, S_max, n_kv, hd]`` and an SSD block ``ssm`` (float32 ``[B, H, N,
P]``) and ``conv`` (``[B, K-1, d_inner + 2N]``), each with a leading
``n_scan`` axis under ``blocks``; ``len`` is int32 ``[B]``.  A decode
step writes every one of them in place.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.dist import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as S
from repro_torch.models import moe as MOE
from repro_torch.models.config import ModelConfig

SUPPORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")


def stack_plan(cfg: ModelConfig):
    """``(prologue, scan_unit, n_scan)`` as in the reference: lists of
    ``(mixer, ffn, d_ff)``."""
    if cfg.family not in SUPPORTED_FAMILIES:
        raise ValueError(f"{cfg.name}: the {cfg.family!r} family has no "
                         f"decoder stack; it runs {SUPPORTED_FAMILIES}")
    if cfg.family == "ssm":
        return [], [("ssm", "none", 0)], cfg.n_layers
    if cfg.hybrid_period:
        unit = [("attn" if j == 0 else "ssm",
                 "moe" if cfg.is_moe_layer(j) else "dense", 0)
                for j in range(cfg.hybrid_period)]
        assert cfg.n_layers % cfg.hybrid_period == 0
        return [], unit, cfg.n_layers // cfg.hybrid_period
    if cfg.n_experts and cfg.dense_first_layer:
        return ([("attn", "dense", cfg.dense_first_d_ff)],
                [("attn", "moe", 0)], cfg.n_layers - 1)
    if cfg.n_experts:
        return [], [("attn", "moe", 0)], cfg.n_layers
    return [], [("attn", "dense", 0)], cfg.n_layers


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
class _Init:
    """Draws the reference's initial values: ``N(0, 1) * scale`` in
    float32, cast to the model's type (or ``dtype``); empty tensors on the
    meta device."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator],
                 device: torch.device):
        self.dtype = getattr(torch, cfg.dtype)
        self.gen, self.device = generator, device

    def _param(self, t: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(t)

    def normal(self, shape, scale: float, dtype=None) -> nn.Parameter:
        dtype = dtype or self.dtype
        if self.device.type == "meta":
            return self._param(torch.empty(shape, dtype=dtype,
                                           device=self.device))
        t = torch.randn(shape, generator=self.gen, device=self.device)
        return self._param((t * scale).to(dtype))

    def fill(self, shape, value: float, dtype=None) -> nn.Parameter:
        return self._param(torch.full(shape, value, device=self.device,
                                      dtype=dtype or self.dtype))


def _norm_params(cfg: ModelConfig, init: _Init) -> nn.ParameterDict:
    p = {"scale": init.fill((cfg.d_model,), 1.0, torch.float32)}
    if cfg.norm == "layernorm":
        p["bias"] = init.fill((cfg.d_model,), 0.0, torch.float32)
    return nn.ParameterDict(p)


def _attn_params(cfg: ModelConfig, init: _Init) -> nn.ParameterDict:
    d, hd, nh, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    s = d ** -0.5
    attn = {"wq": init.normal((d, nh, hd), s),
            "wk": init.normal((d, nkv, hd), s),
            "wv": init.normal((d, nkv, hd), s),
            "wo": init.normal((nh, hd, d), s)}
    if cfg.qkv_bias:
        attn.update(bq=init.fill((nh, hd), 0.0),
                    bk=init.fill((nkv, hd), 0.0),
                    bv=init.fill((nkv, hd), 0.0))
    if cfg.qk_norm:
        attn.update(q_norm=init.fill((hd,), 1.0, torch.float32),
                    k_norm=init.fill((hd,), 1.0, torch.float32))
    return nn.ParameterDict(attn)


def _mlp_params(cfg: ModelConfig, init: _Init, f: int) -> nn.ParameterDict:
    d = cfg.d_model
    mlp = {"wi": init.normal((d, f), d ** -0.5)}
    if cfg.act == "swiglu":
        mlp["wg"] = init.normal((d, f), d ** -0.5)
    mlp["wo"] = init.normal((f, d), f ** -0.5)
    return nn.ParameterDict(mlp)



# ---------------------------------------------------------------------------
# logical axis names (the reference's sharding surface)
# ---------------------------------------------------------------------------
def _flat(tree, prefix: str = "") -> Dict:
    """A nested dict of name tuples flattened to ``{"a.b.c": names}``."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        out.update(_flat(v, key + ".") if isinstance(v, dict) else {key: v})
    return out


def norm_specs(cfg: ModelConfig) -> Dict:
    if cfg.norm == "layernorm":
        return {"scale": ("embed",), "bias": ("embed",)}
    return {"scale": ("embed",)}


def attn_specs(cfg: ModelConfig) -> Dict:
    attn = {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed")}
    if cfg.qkv_bias:
        attn.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                    bv=("kv_heads", "head_dim"))
    if cfg.qk_norm:
        attn.update(q_norm=(None,), k_norm=(None,))
    return attn


def mlp_specs(cfg: ModelConfig) -> Dict:
    mlp = {"wi": ("embed", "mlp")}
    if cfg.act == "swiglu":
        mlp["wg"] = ("embed", "mlp")
    mlp["wo"] = ("mlp", "embed")
    return mlp


def embed_specs(cfg: ModelConfig) -> Dict:
    emb = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        emb["head"] = ("embed", "vocab")
    return emb


def block_specs(cfg: ModelConfig, mixer: str, ffn: str) -> Dict:
    """A `Block`'s parameters' logical names, nested as its
    ``ParameterDict``s are (the reference's ``block_specs``)."""
    p: Dict = {"norm1": norm_specs(cfg)}
    if mixer == "attn":
        p["attn"] = attn_specs(cfg)
    else:
        p["ssm"] = S.mamba_specs(cfg)
    if ffn != "none":
        p["norm2"] = norm_specs(cfg)
    if ffn == "dense":
        p["mlp"] = mlp_specs(cfg)
    elif ffn == "moe":
        p["moe"] = MOE.moe_specs(cfg)
    return p


def decoder_specs(cfg: ModelConfig) -> Dict:
    """Logical axis names of every `Decoder` parameter, keyed as
    ``named_parameters()`` names them (`model.param_specs` orders them).

    Each name tuple is the reference's (`repro.models.transformer.
    decoder_specs`) at the path `repro_torch.convert` maps the parameter
    to, less the leading ``"layers"`` of a scanned block: the port
    unstacks that axis into ``blocks.{n}``, and no rule table shards it.
    """
    pro, unit, n_scan = stack_plan(cfg)
    tree: Dict = {"embed": embed_specs(cfg)}
    for i, (mixer, ffn, _) in enumerate(pro):
        tree[f"pro.{i}"] = block_specs(cfg, mixer, ffn)
    for n in range(n_scan * len(unit)):
        mixer, ffn, _ = unit[n % len(unit)]
        tree[f"blocks.{n}"] = block_specs(cfg, mixer, ffn)
    tree["final_norm"] = norm_specs(cfg)
    return _flat(tree)


def cache_specs(cfg: ModelConfig) -> Dict:
    """Logical names of the decode cache (`init_cache_shapes`'s tree), the
    reference's ``cache_specs``: ``kv_seq`` gives sequence-parallel
    decode."""
    pro, unit, _ = stack_plan(cfg)
    kv = ("batch", "kv_seq", "kv_heads", None)
    ssm = ("batch", "heads", None, None)
    conv = ("batch", None, "ssm_inner")

    def block(mixer, lead=()):
        if mixer == "attn":
            return {"k": lead + kv, "v": lead + kv}
        return {"ssm": lead + ssm, "conv": lead + conv}

    cache = {"blocks": {f"sub{j}": block(m, ("layers",))
                        for j, (m, _, _) in enumerate(unit)},
             "len": (None,)}
    for i, (m, _, _) in enumerate(pro):
        cache[f"pro{i}"] = block(m)
    return cache

def _save_dots(ctx, op, *args, **kwargs):
    """The reference's ``checkpoint_dots_with_no_batch_dims``: keep the
    output of a product with no batch dimension (a weight product; einsum
    lowers it to ``mm`` or a ``bmm`` of batch 1), recompute the rest."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat(mode: str, fn):
    """``fn`` recomputed in the backward pass, as the reference's `_remat`:
    ``"none"`` saves every activation, ``"full"`` only ``fn``'s inputs,
    ``"dots"`` also the products with no batch dimension.  The values are
    ``fn``'s either way, and so is the sharding context it runs under
    (`repro_torch.dist.sharding.context`: a data-parallel MoE router
    reads it).  With autograd off it is ``fn`` itself."""
    if mode not in ("none", "dots", "full"):
        raise ValueError(f"remat {mode!r}: none, dots or full")
    if mode == "none":
        return fn
    kw = {}
    if mode == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_dots)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # the backward recomputes ``fn`` on autograd's thread: under the
        # sharding context of this forward, not that thread's (empty) one
        saved = SH.context()

        def again(*a):
            with SH.in_context(saved):
                return fn(*a)

        return _ckpt.checkpoint(again, *args, use_reentrant=False, **kw)

    return run


def _embed_params(cfg: ModelConfig, init: _Init) -> nn.ParameterDict:
    s = cfg.d_model ** -0.5
    emb = {"tok": init.normal((cfg.vocab_padded, cfg.d_model), s)}
    if not cfg.tie_embeddings:
        emb["head"] = init.normal((cfg.d_model, cfg.vocab_padded), s)
    return nn.ParameterDict(emb)


def _commit(dst: torch.Tensor, new: torch.Tensor, active):
    """Write a decode step's new recurrent state into ``dst`` in place;
    with ``active`` (bool ``[B]``), only the active rows take it."""
    if active is not None:
        new = torch.where(active.view(-1, *([1] * (new.dim() - 1))), new, dst)
    dst.copy_(new)


class Block(nn.Module):
    """One layer, a mixer and an FFN: ``norm1`` and ``attn`` or ``ssm``,
    then, unless the FFN is ``"none"``, ``norm2`` and ``mlp`` or ``moe``,
    each holding the reference block's parameter dict."""

    def __init__(self, cfg: ModelConfig, init: _Init, mixer: str = "attn",
                 ffn: str = "dense", d_ff: int = 0):
        super().__init__()
        self.mixer, self.ffn = mixer, ffn
        self.norm1 = _norm_params(cfg, init)
        if mixer == "attn":
            self.attn = _attn_params(cfg, init)
        else:
            self.ssm = S.init_mamba(cfg, init)
        if ffn != "none":
            self.norm2 = _norm_params(cfg, init)
        if ffn == "dense":
            self.mlp = _mlp_params(cfg, init, d_ff or cfg.d_ff)
        elif ffn == "moe":
            self.moe = MOE.init_moe(cfg, init)

    def _ffn(self, cfg: ModelConfig, x, aux):
        if self.ffn == "none":
            return x, aux
        h = L.norm(cfg, x, self.norm2)
        if self.ffn == "dense":
            return x + L.mlp(cfg, self.mlp, h), aux
        h, a = MOE.moe_ffn(cfg, self.moe, h)
        return x + h, aux + a

    def forward(self, cfg: ModelConfig, x, positions, aux,
                causal: bool = True):
        h = L.norm(cfg, x, self.norm1)
        if self.mixer == "attn":
            h = L.attention(cfg, self.attn, h, positions, causal=causal)
        else:
            h = S.mamba_layer(cfg, self.ssm, h)
        return self._ffn(cfg, x + h, aux)

    def decode(self, cfg: ModelConfig, x, positions, cache: Dict, cache_len,
               active=None):
        """One token; ``cache`` holds this block's tensors, written in
        place (attention: at ``cache_len``; SSD: the whole state, or only
        the ``active`` rows)."""
        h = L.norm(cfg, x, self.norm1)
        if self.mixer == "attn":
            h, _, _ = L.attention_kv(cfg, self.attn, h, positions,
                                     cache["k"], cache["v"], cache_len)
        else:
            h, st, cs = S.mamba_decode(cfg, self.ssm, h, cache["ssm"],
                                       cache["conv"])
            _commit(cache["ssm"], st, active)
            _commit(cache["conv"], cs, active)
        return self._ffn(cfg, x + h, 0.0)[0]


class Decoder(nn.Module):
    """The whole stack: ``embed`` (``tok``, and ``head`` when untied), the
    prologue ``pro``, the scanned ``blocks`` (``unit_len`` a unit) and
    ``final_norm``."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        pro, unit, n_scan = stack_plan(cfg)
        init = _Init(cfg, generator, torch.device(device or "cpu"))
        self.cfg = cfg
        self.embed = _embed_params(cfg, init)
        self.pro = nn.ModuleList(Block(cfg, init, *spec) for spec in pro)
        self.unit_len = len(unit)
        self.blocks = nn.ModuleList(Block(cfg, init, *unit[j])
                                    for _ in range(n_scan)
                                    for j in range(len(unit)))
        self.final_norm = _norm_params(cfg, init)

    def forward(self, tokens):
        return decoder_forward(self.cfg, self, tokens)


# ---------------------------------------------------------------------------
# forward (prefill) and decode
# ---------------------------------------------------------------------------
def decoder_forward(cfg: ModelConfig, params: Decoder, tokens,
                    causal: bool = True):
    """tokens [B, S] -> (logits [B, S, V], aux loss, a float32 scalar:
    the MoE layers' sum).  Each scanned unit is one `remat` unit.

    The units of a data-parallel step's parameter gathers
    (`sharding.gathered`) are each prologue block, each scanned unit
    (inside its `remat`, so that a recomputation gathers again) and the
    embedding with ``final_norm``, used at both ends."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    ends = [params.embed, params.final_norm]
    x = SH.gathered(ends, L.embed)(cfg, params.embed, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for blk in params.pro:
        x, aux = SH.gathered([blk], blk)(cfg, x, positions, aux, causal)
    u = params.unit_len

    def unit(i):
        blocks = params.blocks[i * u:(i + 1) * u]

        def body(x, aux):
            for blk in blocks:
                x, aux = blk(cfg, x, positions, aux, causal)
            return x, aux
        return remat(cfg.remat, SH.gathered(blocks, body,
                                            saved=cfg.remat == "none"))

    for i in range(len(params.blocks) // u):
        x, aux = unit(i)(x, aux)

    def head(x):
        return L.unembed(cfg, params.embed, L.norm(cfg, x, params.final_norm))

    return SH.gathered(ends, head)(x), aux


def init_cache_shapes(cfg: ModelConfig, batch: int, s_max: int):
    """The decode cache as meta tensors (shape and type, no storage), as
    the reference's ``init_cache_shapes``."""
    pro, unit, n_scan = stack_plan(cfg)
    dt = getattr(torch, cfg.dtype)
    kv = (batch, s_max, cfg.n_kv_heads, cfg.hd)
    ssm = (batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
    conv = (batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def block(mixer, lead=()):
        if mixer == "attn":
            return {"k": meta(lead + kv, dt), "v": meta(lead + kv, dt)}
        return {"ssm": meta(lead + ssm, torch.float32),
                "conv": meta(lead + conv, dt)}

    cache = {"blocks": {f"sub{j}": block(m, (n_scan,))
                        for j, (m, _, _) in enumerate(unit)},
             "len": meta((batch,), torch.int32)}
    for i, (m, _, _) in enumerate(pro):
        cache[f"pro{i}"] = block(m)
    return cache


def recurrent_state(cache: Dict):
    """The cache's SSD tensors (``ssm`` and ``conv``), each with its batch
    axis: ``[(tensor, batch_dim), ...]``; empty for attention-only
    stacks."""
    out = []
    for name, sub in cache.items():
        if not isinstance(sub, dict):       # len; the encdec cache's leaves
            continue
        subs = sub.values() if name == "blocks" else (sub,)
        for c in subs:
            out += [(c[k], 1 if name == "blocks" else 0)
                    for k in ("ssm", "conv") if k in c]
    return out


@torch.no_grad()
def decoder_decode(cfg: ModelConfig, params: Decoder, cache: Dict, tokens,
                   active: Optional[torch.Tensor] = None):
    """One decode step.  tokens [B, 1]; returns (logits [B, V], cache).

    The returned cache shares its tensors with ``cache``, which this step
    has written in place (`layers.attention_kv`, `_commit`); its ``len``
    is ``cache["len"] + 1``.  ``active`` (bool ``[B]``, or None for all)
    names the rows whose recurrent (SSD) state advances; attention rows
    are written at their ``len`` whatever it says."""
    cache_len = cache["len"]
    positions = cache_len[:, None]
    x = L.embed(cfg, params.embed, tokens)
    for i, blk in enumerate(params.pro):
        x = blk.decode(cfg, x, positions, cache[f"pro{i}"], cache_len, active)
    for n, blk in enumerate(params.blocks):
        i, j = divmod(n, params.unit_len)
        c = {k: t[i] for k, t in cache["blocks"][f"sub{j}"].items()}
        x = blk.decode(cfg, x, positions, c, cache_len, active)
    x = L.norm(cfg, x, params.final_norm)
    logits = L.unembed(cfg, params.embed, x)[:, 0]
    return logits, dict(cache, len=cache_len + 1)
