"""The decoder stack for the dense and vlm families, as an ``nn.Module``.

The reference (`repro.models.transformer`) composes every family from one
block, a mixer (attention or SSD) and an FFN (dense or MoE), and scans
over a stack of identical units.  The dense and vlm families are L
identical (attention, dense FFN) blocks; here each is a `Block` in a
``ModuleList``, and the scan is a loop.  The other families (moe, ssm,
hybrid, encdec) raise `NotImplementedError`: they wait for ROADMAP
item 13.

Parameters are keyed as the reference's tree is, with the leading layer
axis of ``params["blocks"]["sub0"]`` unstacked into ``blocks[i]``
(`repro_torch.convert.decoder_from_reference`).  Weights are made with an
explicit ``torch.Generator`` at the reference's scales; they need no
gradient (the port serves; training is a later slice).

The decode cache mirrors the reference's tree: ``{"blocks": {"sub0":
{"k", "v"}}, "len"}`` with k/v ``[L, B, S_max, n_kv, hd]`` and ``len``
int32 ``[B]``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

SUPPORTED_FAMILIES = ("dense", "vlm")


def stack_plan(cfg: ModelConfig):
    """``(prologue, scan_unit, n_scan)`` as in the reference; only the
    dense and vlm families' plan is ported."""
    if (cfg.family not in SUPPORTED_FAMILIES or cfg.n_experts
            or cfg.hybrid_period):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP item 13); the port runs {SUPPORTED_FAMILIES}")
    return [], [("attn", "dense", 0)], cfg.n_layers


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
class _Init:
    """Draws the reference's initial values: ``N(0, 1) * scale`` in
    float32, cast to the model's type; empty tensors on the meta device."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator],
                 device: torch.device):
        self.dtype = getattr(torch, cfg.dtype)
        self.gen, self.device = generator, device

    def _param(self, t: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(t, requires_grad=False)

    def normal(self, shape, scale: float) -> nn.Parameter:
        if self.device.type == "meta":
            return self._param(torch.empty(shape, dtype=self.dtype,
                                           device=self.device))
        t = torch.randn(shape, generator=self.gen, device=self.device)
        return self._param((t * scale).to(self.dtype))

    def fill(self, shape, value: float, dtype=None) -> nn.Parameter:
        return self._param(torch.full(shape, value, device=self.device,
                                      dtype=dtype or self.dtype))


def _norm_params(cfg: ModelConfig, init: _Init) -> nn.ParameterDict:
    p = {"scale": init.fill((cfg.d_model,), 1.0, torch.float32)}
    if cfg.norm == "layernorm":
        p["bias"] = init.fill((cfg.d_model,), 0.0, torch.float32)
    return nn.ParameterDict(p)


class Block(nn.Module):
    """One (attention, dense FFN) layer: ``norm1``, ``attn``, ``norm2``
    and ``mlp`` hold the reference block's parameter dicts."""

    def __init__(self, cfg: ModelConfig, init: _Init, d_ff: int = 0):
        super().__init__()
        d, hd, nh, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
        f = d_ff or cfg.d_ff
        s = d ** -0.5
        self.norm1 = _norm_params(cfg, init)
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
        self.attn = nn.ParameterDict(attn)
        self.norm2 = _norm_params(cfg, init)
        mlp = {"wi": init.normal((d, f), s)}
        if cfg.act == "swiglu":
            mlp["wg"] = init.normal((d, f), s)
        mlp["wo"] = init.normal((f, d), f ** -0.5)
        self.mlp = nn.ParameterDict(mlp)

    def forward(self, cfg: ModelConfig, x, positions, causal: bool = True):
        x = x + L.attention(cfg, self.attn, L.norm(cfg, x, self.norm1),
                            positions, causal=causal)
        return x + L.mlp(cfg, self.mlp, L.norm(cfg, x, self.norm2))

    def decode(self, cfg: ModelConfig, x, positions, k, v, cache_len):
        h, _, _ = L.attention_kv(cfg, self.attn, L.norm(cfg, x, self.norm1),
                                 positions, k, v, cache_len)
        x = x + h
        return x + L.mlp(cfg, self.mlp, L.norm(cfg, x, self.norm2))


class Decoder(nn.Module):
    """The whole stack: ``embed`` (``tok``, and ``head`` when untied),
    ``blocks`` and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        _, unit, n_scan = stack_plan(cfg)
        init = _Init(cfg, generator, torch.device(device or "cpu"))
        self.cfg = cfg
        s = cfg.d_model ** -0.5
        emb = {"tok": init.normal((cfg.vocab_padded, cfg.d_model), s)}
        if not cfg.tie_embeddings:
            emb["head"] = init.normal((cfg.d_model, cfg.vocab_padded), s)
        self.embed = nn.ParameterDict(emb)
        self.blocks = nn.ModuleList(
            Block(cfg, init, unit[0][2]) for _ in range(n_scan))
        self.final_norm = _norm_params(cfg, init)

    def forward(self, tokens):
        return decoder_forward(self.cfg, self, tokens)


# ---------------------------------------------------------------------------
# forward (prefill) and decode
# ---------------------------------------------------------------------------
def decoder_forward(cfg: ModelConfig, params: Decoder, tokens,
                    causal: bool = True):
    """tokens [B, S] -> (logits [B, S, V], aux loss scalar)."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = L.embed(cfg, params.embed, tokens)
    for blk in params.blocks:
        x = blk(cfg, x, positions, causal)
    x = L.norm(cfg, x, params.final_norm)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return L.unembed(cfg, params.embed, x), aux


def init_cache_shapes(cfg: ModelConfig, batch: int, s_max: int):
    """The decode cache as meta tensors (shape and type, no storage)."""
    _, _, n_scan = stack_plan(cfg)
    kv = (n_scan, batch, s_max, cfg.n_kv_heads, cfg.hd)
    dt = getattr(torch, cfg.dtype)
    return {"blocks": {"sub0": {"k": torch.empty(kv, dtype=dt, device="meta"),
                                "v": torch.empty(kv, dtype=dt, device="meta")}},
            "len": torch.empty((batch,), dtype=torch.int32, device="meta")}


def decoder_decode(cfg: ModelConfig, params: Decoder, cache: Dict, tokens):
    """One decode step.  tokens [B, 1]; returns (logits [B, V], cache).

    The returned cache shares its k/v tensors with ``cache``, which this
    step has written in place (`layers.attention_kv`); its ``len`` is
    ``cache["len"] + 1``."""
    cache_len = cache["len"]
    positions = cache_len[:, None]
    kv = cache["blocks"]["sub0"]
    x = L.embed(cfg, params.embed, tokens)
    for i, blk in enumerate(params.blocks):
        x = blk.decode(cfg, x, positions, kv["k"][i], kv["v"][i], cache_len)
    x = L.norm(cfg, x, params.final_norm)
    logits = L.unembed(cfg, params.embed, x)[:, 0]
    return logits, {"blocks": cache["blocks"], "len": cache_len + 1}
