"""Mamba-2 SSD layer (state-space duality, arXiv:2405.21060).

The reference's `repro.models.mamba2` in plain torch (it has no Pallas
kernel).  The chunked SSD is a matmul formulation: inside a chunk the
output is a masked ``[Q, Q]`` "attention" product; across chunks a small
recurrence carries the state ``[H, N, P]``.  The reference scans the
chunks with ``lax.scan``; here a Python loop does, in float32 throughout.

Decode is the recurrence of one step, ``h <- exp(dt*a)*h + dt*B x`` and
``y = C.h``: a constant state a layer (``[B, H, N, P]`` float32) and a
causal-conv history (``[B, K-1, d_inner + 2N]``), no KV growth.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm, silu


def init_mamba(cfg: ModelConfig, init) -> nn.ParameterDict:
    """The reference's ``init_mamba`` shapes and scales; ``init`` is the
    decoder's initialiser (`transformer._Init`)."""
    d, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    f32 = torch.float32
    return nn.ParameterDict({
        # input projection -> [x (di), z gate (di), B (ns), C (ns), dt (nh)]
        "w_in": init.normal((d, 2 * di + 2 * ns + nh), d ** -0.5),
        "w_out": init.normal((di, d), di ** -0.5),
        "conv_w": init.normal((cfg.ssm_conv, di + 2 * ns), 0.1),
        "A_log": init.fill((nh,), 0.0, f32),
        "D": init.fill((nh,), 1.0, f32),
        "dt_bias": init.fill((nh,), 0.0, f32),
        "norm_scale": init.fill((di,), 1.0, f32),
    })



def mamba_specs(cfg: ModelConfig) -> dict:
    """Logical axis names of `init_mamba`'s parameters (the reference's
    ``mamba_specs``)."""
    return {
        "w_in": ("embed", "ssm_inner"),
        "w_out": ("ssm_inner", "embed"),
        "conv_w": ("conv", "ssm_inner"),
        "A_log": ("state",),
        "D": ("state",),
        "dt_bias": ("state",),
        "norm_scale": ("ssm_inner",),
    }

def _split_proj(cfg: ModelConfig, proj):
    di, ns = cfg.d_inner, cfg.ssm_state
    return (proj[..., :di], proj[..., di:2 * di],
            proj[..., 2 * di:2 * di + ns], proj[..., 2 * di + ns:2 * di + 2 * ns],
            proj[..., 2 * di + 2 * ns:])


def _causal_conv(x, w, state=None):
    """Depthwise causal conv (kernel K) by shifted adds.

    x [B, S, F]; w [K, F].  With ``state`` (decode: the last K-1 inputs,
    [B, K-1, F]) returns ``(out [B, 1, F], new state)``."""
    k = w.shape[0]
    if state is None:
        out = x * w[-1]
        for i in range(1, k):
            shifted = F.pad(x, (0, 0, i, 0))[:, :x.shape[1]]
            out = out + shifted * w[-1 - i]
        return out
    hist = torch.cat([state, x], dim=1)               # [B, K, F]
    out = torch.einsum("bkf,kf->bf", hist, w)[:, None]
    return out, hist[:, 1:]


def ssd_chunked(cfg: ModelConfig, xh, Bm, Cm, dt, A_log, D):
    """Chunked SSD scan, float32.

    xh [B, S, H, P]; Bm/Cm [B, S, N]; dt [B, S, H] (after softplus).
    Returns y [B, S, H, P] float32."""
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    q = min(cfg.ssm_chunk, s)
    assert s % q == 0, f"seq {s} % ssm_chunk {q} != 0"
    c = s // q

    a = -torch.exp(A_log.float())                     # [H], negative decay
    dt = dt.float()
    dta = (dt * a[None, None, :]).reshape(b, c, q, h)
    xc = xh.reshape(b, c, q, h, p).float()
    Bc = Bm.reshape(b, c, q, n).float()
    Cc = Cm.reshape(b, c, q, n).float()
    dtc = dt.reshape(b, c, q, h)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=xh.device))[None, :, :, None]

    hstate = torch.zeros((b, h, n, p), dtype=torch.float32, device=xh.device)
    ys = []
    for ci in range(c):
        xq, Bq, Cq, dtq = xc[:, ci], Bc[:, ci], Cc[:, ci], dtc[:, ci]
        seg = torch.cumsum(dta[:, ci], dim=1)                    # [B,Q,H]
        decay = seg[:, :, None, :] - seg[:, None, :, :]          # [B,Q,Q,H]
        # mask BEFORE exp: the upper triangle has decay > 0 and would
        # overflow to inf
        gate = torch.exp(torch.where(causal, decay, -1e30))
        cb = torch.einsum("bin,bjn->bij", Cq, Bq)
        y = torch.einsum("bij,bijh,bjh,bjhp->bihp", cb, gate, dtq, xq)
        # inter-chunk contribution from the carried state
        y = y + torch.einsum("bqn,bhnp,bqh->bqhp", Cq, hstate,
                             torch.exp(seg))
        ys.append(y)
        last = seg[:, -1:, :]                                    # [B,1,H]
        states = torch.einsum("bqh,bqh,bqn,bqhp->bhnp",
                              torch.exp(last - seg), dtq, Bq, xq)
        hstate = hstate * torch.exp(last[:, 0])[:, :, None, None] + states
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y + xh.float() * D.float()[None, None, :, None]


def mamba_layer(cfg: ModelConfig, p, x):
    """x [B, S, d] -> [B, S, d] (prefill)."""
    b, s, _ = x.shape
    di, ns, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = torch.einsum("bsd,de->bse", x, p["w_in"])
    xi, z, Bm, Cm, dt = _split_proj(cfg, proj)
    conv_out = silu(_causal_conv(torch.cat([xi, Bm, Cm], dim=-1),
                                 p["conv_w"]))
    xi, Bm, Cm = (conv_out[..., :di], conv_out[..., di:di + ns],
                  conv_out[..., di + ns:])
    dt = F.softplus(dt.float() + p["dt_bias"])
    y = ssd_chunked(cfg, xi.reshape(b, s, nh, hd), Bm, Cm, dt, p["A_log"],
                    p["D"])
    y = y.reshape(b, s, di).to(x.dtype) * silu(z)
    y = rmsnorm(y, p["norm_scale"])
    return torch.einsum("bse,ed->bsd", y, p["w_out"])


def mamba_decode(cfg: ModelConfig, p, x, ssm_state, conv_state):
    """One decode step.  x [B, 1, d]; ssm_state [B, H, N, P] float32;
    conv_state [B, K-1, d_inner + 2N].  Returns ``(y, ssm_state,
    conv_state)``, the states new tensors."""
    b = x.shape[0]
    di, ns, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = torch.einsum("bsd,de->bse", x, p["w_in"])
    xi, z, Bm, Cm, dt = _split_proj(cfg, proj)
    conv_out, conv_state = _causal_conv(torch.cat([xi, Bm, Cm], dim=-1),
                                        p["conv_w"], conv_state)
    conv_out = silu(conv_out)
    xi, Bm, Cm = (conv_out[..., :di], conv_out[..., di:di + ns],
                  conv_out[..., di + ns:])
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]           # [B,H]
    da = torch.exp(dt * -torch.exp(p["A_log"])[None])          # [B,H]
    xh = xi.reshape(b, nh, hd).float()
    Bf, Cf = Bm[:, 0].float(), Cm[:, 0].float()                # [B,N]
    upd = torch.einsum("bh,bn,bhp->bhnp", dt, Bf, xh)
    ssm_state = ssm_state * da[:, :, None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", Cf, ssm_state)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(b, 1, di).to(x.dtype) * silu(z)
    y = rmsnorm(y, p["norm_scale"])
    return (torch.einsum("bse,ed->bsd", y, p["w_out"]), ssm_state,
            conv_state)
