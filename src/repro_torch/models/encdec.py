"""Encoder-decoder (the whisper-tiny backbone), as the reference's
`repro.models.encdec`.

The audio frontend (log-mel and convolutions) is a stub there and here:
the caller gives precomputed frame embeddings ``[B, S_enc, d_model]``.
The backbone: a bidirectional encoder with learned positions, a causal
decoder with cross attention, layernorm and gelu, multi-head attention
(``n_kv == n_heads``), no RoPE.

`EncDec` holds the reference's tree: ``embed``, ``enc_pos``
(``[encoder_seq, d]``), ``dec_pos`` (``[32768, d]``), the ``enc`` blocks
(``norm1``, ``attn``, ``norm2``, ``mlp``), the ``dec`` blocks (adding
``norm_x`` and ``xattn``), ``enc_norm`` and ``final_norm``; the
reference's stacked layer axis of ``enc`` and ``dec`` is a module list
(`repro_torch.convert.encdec_from_reference`).  The decode cache is
``{"k", "v"}`` (``[L, B, S_max, n_kv, hd]``), ``enc_out`` (``[B,
encoder_seq, d]``) and ``len`` (int32 ``[B]``); a decode step reads
``enc_out`` as it finds it and writes ``k``/``v`` in place.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

#: learned decoder positions (the reference's table size)
DEC_POSITIONS = 32768


class _EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, init):
        super().__init__()
        self.norm1 = T._norm_params(cfg, init)
        self.attn = T._attn_params(cfg, init)
        self.norm2 = T._norm_params(cfg, init)
        self.mlp = T._mlp_params(cfg, init, cfg.d_ff)


class _DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, init):
        super().__init__()
        self.norm1 = T._norm_params(cfg, init)
        self.attn = T._attn_params(cfg, init)
        self.norm_x = T._norm_params(cfg, init)
        self.xattn = T._attn_params(cfg, init)
        self.norm2 = T._norm_params(cfg, init)
        self.mlp = T._mlp_params(cfg, init, cfg.d_ff)


class EncDec(nn.Module):
    """The whole encoder-decoder, weights drawn from ``generator`` at the
    reference's scales (positions ``N(0, 0.02^2)``)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        init = T._Init(cfg, generator, torch.device(device or "cpu"))
        self.cfg = cfg
        self.embed = T._embed_params(cfg, init)
        self.enc_pos = init.normal((cfg.encoder_seq, cfg.d_model), 0.02)
        self.dec_pos = init.normal((DEC_POSITIONS, cfg.d_model), 0.02)
        self.enc = nn.ModuleList(_EncBlock(cfg, init)
                                 for _ in range(cfg.encoder_layers))
        self.dec = nn.ModuleList(_DecBlock(cfg, init)
                                 for _ in range(cfg.n_layers))
        self.enc_norm = T._norm_params(cfg, init)
        self.final_norm = T._norm_params(cfg, init)



def encdec_specs(cfg: ModelConfig) -> Dict:
    """Logical axis names of every `EncDec` parameter, keyed as
    ``named_parameters()`` names them: the reference's
    ``encdec_specs`` less the leading ``"layers"`` of the ``enc`` and
    ``dec`` stacks, which the port unstacks."""
    norm, attn, mlp = T.norm_specs(cfg), T.attn_specs(cfg), T.mlp_specs(cfg)
    tree: Dict = {"embed": T.embed_specs(cfg), "enc_pos": (None, "embed"),
                  "dec_pos": (None, "embed")}
    for i in range(cfg.encoder_layers):
        tree[f"enc.{i}"] = {"norm1": norm, "attn": attn, "norm2": norm,
                            "mlp": mlp}
    for i in range(cfg.n_layers):
        tree[f"dec.{i}"] = {"norm1": norm, "attn": attn, "norm_x": norm,
                            "xattn": attn, "norm2": norm, "mlp": mlp}
    tree.update(enc_norm=norm, final_norm=norm)
    return T._flat(tree)

def encode(cfg: ModelConfig, params: EncDec, frames):
    """frames [B, S_enc, d] stub embeddings -> encoder states."""
    b, s = frames.shape[:2]
    x = frames + params.enc_pos[None, :s]
    positions = torch.arange(s, device=frames.device).expand(b, s)
    for lp in params.enc:
        h = L.norm(cfg, x, lp.norm1)
        x = x + L.attention(cfg, lp.attn, h, positions, causal=False)
        h = L.norm(cfg, x, lp.norm2)
        x = x + L.mlp(cfg, lp.mlp, h)
    return L.norm(cfg, x, params.enc_norm)


def encdec_forward(cfg: ModelConfig, params: EncDec, frames, tokens):
    """Training and prefill: (frames [B, Se, d], tokens [B, Sd]) ->
    (logits [B, Sd, V], a zero aux loss).  Each decoder layer is one
    `transformer.remat` unit, recomputed whole when ``cfg.remat`` is not
    ``"none"``, as the reference's ``jax.checkpoint`` of its body."""
    enc_out = encode(cfg, params, frames)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = L.embed(cfg, params.embed, tokens) + params.dec_pos[None, :s]

    def layer(lp):
        def body(x):
            h = L.norm(cfg, x, lp.norm1)
            x = x + L.attention(cfg, lp.attn, h, positions, causal=True)
            h = L.norm(cfg, x, lp.norm_x)
            x = x + L.cross_attention(cfg, lp.xattn, h, enc_out)
            h = L.norm(cfg, x, lp.norm2)
            return x + L.mlp(cfg, lp.mlp, h)
        return T.remat("none" if cfg.remat == "none" else "full", body)

    for lp in params.dec:
        x = layer(lp)(x)
    x = L.norm(cfg, x, params.final_norm)
    logits = L.unembed(cfg, params.embed, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def encdec_cache_shapes(cfg: ModelConfig, batch: int, s_max: int):
    """The decode cache as meta tensors, as the reference's
    ``encdec_cache_shapes``."""
    dt = getattr(torch, cfg.dtype)
    kv = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.hd)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    return {"k": meta(kv, dt), "v": meta(kv, dt),
            "enc_out": meta((batch, cfg.encoder_seq, cfg.d_model), dt),
            "len": meta((batch,), torch.int32)}



def encdec_cache_specs(cfg: ModelConfig) -> Dict:
    kv = ("layers", "batch", "kv_seq", "kv_heads", None)
    return {"k": kv, "v": kv, "enc_out": ("batch", None, None),
            "len": (None,)}

@torch.no_grad()
def encdec_decode(cfg: ModelConfig, params: EncDec, cache: Dict, tokens):
    """One decode step with the cached encoder states and the decoder's
    KV cache: tokens [B, 1] -> (logits [B, V], cache).  ``k``/``v`` are
    written in place at ``len``; the returned cache's ``len`` is ``len +
    1``."""
    cache_len = cache["len"]
    positions = cache_len[:, None]
    x = L.embed(cfg, params.embed, tokens)
    pos = params.dec_pos[torch.clamp(cache_len.long(), 0, DEC_POSITIONS - 1)]
    x = x + pos[:, None]
    enc_out = cache["enc_out"]
    for i, lp in enumerate(params.dec):
        h = L.norm(cfg, x, lp.norm1)
        h, _, _ = L.attention_kv(cfg, lp.attn, h, positions, cache["k"][i],
                                 cache["v"][i], cache_len)
        x = x + h
        h = L.norm(cfg, x, lp.norm_x)
        x = x + L.cross_attention(cfg, lp.xattn, h, enc_out)
        h = L.norm(cfg, x, lp.norm2)
        x = x + L.mlp(cfg, lp.mlp, h)
    x = L.norm(cfg, x, params.final_norm)
    logits = L.unembed(cfg, params.embed, x)[:, 0]
    return logits, dict(cache, len=cache_len + 1)
