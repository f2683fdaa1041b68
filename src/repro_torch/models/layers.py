"""Shared model layers: norms, RoPE, GQA attention, MLPs, embeddings.

Plain functions over tensors; ``p`` is any mapping of name -> tensor (a
block's ``nn.ParameterDict``), keyed as the reference's parameter tree
is (`repro.models.layers`).  Layouts are the reference's: activations
``[B, S, d]``, attention weights ``[d, heads, head_dim]``, caches ``[B,
S_max, n_kv, head_dim]``.  The reference's sharding annotations have no
counterpart here: a data-parallel rank runs these layers on its slice of
the batch, with the parameters of the unit that calls them gathered whole
for the call (`repro_torch.train.train_step.DataParallel`).

Attention is the reference's flash-style online softmax over KV chunks,
with the whole query axis at once, in plain torch: the reference computes
it in JAX with no Pallas kernel.  Scores, softmax and the weighted sum run
in float32 whatever the model's type, as there.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.models.config import ModelConfig

#: the reference's mask value; a masked score must match it exactly, and
#: ``-inf`` would turn a fully masked chunk's running max into NaNs
NEG_INF = -1.0e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm(x, scale, bias=None, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def norm(cfg: ModelConfig, x, p):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"] if "bias" in p else None)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [..., S].  Rotates the two
    concatenated halves of D (not interleaved pairs), in float32."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., :, None].float() * freqs       # [..., S, half]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _qkv(cfg: ModelConfig, p, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if cfg.rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _pick_chunk(s_len: int, target: int) -> int:
    """Largest divisor of s_len <= target (>= 128); whole-seq if none."""
    if s_len <= target:
        return s_len
    for d in range(target, 127, -1):
        if s_len % d == 0:
            return d
    return s_len


def _flash_body(q, k, v, q_pos, k_pos, causal: bool, window: int, scale):
    """One (all queries, kv-chunk) online-softmax step.

    q: [B, S, H, D]; k/v: [B, Kb, G, D] (GQA groups broadcast).
    Returns the unnormalized accumulators (m, l, acc).
    """
    b, qb, h, d = q.shape
    g = k.shape[2]
    qg = q.reshape(b, qb, g, h // g, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float()) * scale
    mask = torch.ones((qb, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)                                       # [b,g,r,q]
    pr = torch.exp(s - m[..., None])
    return m, pr.sum(-1), torch.einsum("bgrqk,bkgd->bgrqd", pr, v.float())


def attention(cfg: ModelConfig, p, x, positions, causal: bool = True):
    """Prefill attention: online softmax over KV chunks of
    ``_pick_chunk(S, cfg.attn_chunk)`` keys, every query at once."""
    b, s_len, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rep = nh // nkv
    scale = hd ** -0.5
    ck = _pick_chunk(s_len, cfg.attn_chunk)
    q_pos = torch.arange(s_len, device=x.device)

    m = torch.full((b, nkv, rep, s_len), NEG_INF, device=x.device)
    l = torch.zeros((b, nkv, rep, s_len), device=x.device)
    a = torch.zeros((b, nkv, rep, s_len, hd), device=x.device)
    for start in range(0, s_len, ck):
        k_pos = q_pos[start:start + ck]
        m_n, l_n, a_n = _flash_body(q, k[:, start:start + ck],
                                    v[:, start:start + ck], q_pos, k_pos,
                                    causal, cfg.attn_window, scale)
        m_new = torch.maximum(m, m_n)
        c_p, c_n = torch.exp(m - m_new), torch.exp(m_n - m_new)
        l = l * c_p + l_n * c_n
        a = a * c_p[..., None] + a_n * c_n[..., None]
        m = m_new
    out = a / torch.clamp(l, min=1e-30)[..., None]      # [b,g,r,s,hd]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s_len, nh, hd).to(x.dtype)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


@torch.no_grad()
def attention_kv(cfg: ModelConfig, p, x, positions, cache_k, cache_v,
                 cache_len):
    """Decode step: one new token per sequence attending to the cache.

    x: [B, 1, d]; cache_k/v: [B, S_max, n_kv, hd]; cache_len: [B] fill.
    The new K/V is written into the cache IN PLACE at ``cache_len`` (the
    reference returns updated copies; the values are the same), then
    attention runs over the whole cache with ``k_pos <= cache_len``.  A
    row whose ``cache_len`` is ``S_max`` or more writes nothing, as the
    reference's ``.at[].set`` drops an index out of range; the write is a
    select at a clamped index, so the card never syncs on it.  A serving
    op: it builds no autograd graph.
    """
    b = x.shape[0]
    q, k, v = _qkv(cfg, p, x, positions)
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s_max = cache_k.shape[1]

    bidx = torch.arange(b, device=x.device)
    at = torch.clamp(cache_len.long(), 0, s_max - 1)
    fits = (cache_len < s_max)[:, None, None]
    cache_k[bidx, at] = torch.where(fits, k[:, 0], cache_k[bidx, at])
    cache_v[bidx, at] = torch.where(fits, v[:, 0], cache_v[bidx, at])

    qg = q.reshape(b, 1, nkv, nh // nkv, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                     cache_k.float()) * (hd ** -0.5)
    k_pos = torch.arange(s_max, device=x.device)
    valid = k_pos[None] <= cache_len[:, None]
    if cfg.attn_window:
        valid &= (positions[:, -1:] - k_pos[None]) < cfg.attn_window
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bgrqd", w, cache_v.float())
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, nh, hd).to(x.dtype)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache_k, cache_v


def cross_attention(cfg: ModelConfig, p, x, enc_out):
    """Encoder-decoder cross attention (whisper): every query over every
    encoder state, no mask, one block of ``_pick_chunk(S, 512)`` queries
    at a time (the reference's ``lax.map``); scores and softmax in
    float32."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b, sq = x.shape[0], x.shape[1]
    kf, vf = k.float(), v.float()
    outs = []
    ck = _pick_chunk(sq, 512)
    for start in range(0, sq, ck):
        qb = q[:, start:start + ck]
        qg = qb.reshape(b, qb.shape[1], nkv, nh // nkv, hd)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), kf) * (hd ** -0.5)
        w = torch.softmax(s, dim=-1)
        out = torch.einsum("bgrqk,bkgd->bgrqd", w, vf)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, qb.shape[1], nh,
                                                         hd))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def silu(x):
    """``x * (1 / (1 + exp(-x)))``, each step rounded to ``x``'s type, as
    ``jax.nn.silu`` lowers: in bf16 `F.silu`, which rounds once, differs
    from it by an ulp on ~40% of inputs."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


@functools.lru_cache(maxsize=None)
def _gelu_constants(dtype):
    """``sqrt(2/pi)`` and 0.044715 rounded to ``dtype``, as Python floats
    (no device copy, so a decode step that uses them can be captured)."""
    return tuple(float(torch.tensor(v, dtype=dtype))
                 for v in (math.sqrt(2 / math.pi), 0.044715))


def gelu(x):
    """``jax.nn.gelu``'s default (tanh) form, each step rounded to ``x``'s
    type and its constants too, as it lowers: in bf16 `F.gelu`, which
    rounds once, differs from it on ~40% of inputs, this on none."""
    c, k = _gelu_constants(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def mlp(cfg: ModelConfig, p, x):
    h = torch.einsum("bsd,df->bsf", x, p["wi"])
    if cfg.act == "swiglu":
        h = silu(torch.einsum("bsd,df->bsf", x, p["wg"])) * h
    else:
        h = gelu(h)
    return torch.einsum("bsf,fd->bsd", h, p["wo"])


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------
def embed(cfg: ModelConfig, p, tokens):
    return p["tok"][tokens]


def unembed(cfg: ModelConfig, p, x):
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, p["tok"])
    return torch.einsum("bsd,dv->bsv", x, p["head"])
