"""Mixture-of-Experts FFN with the sorted (learned-index style) dispatch.

The reference's `repro.models.moe` in plain torch.  Dispatch modes
(``cfg.moe_dispatch``):

  dense    every expert runs every token and the router's weights select
           the outputs: E/k times the useful work, the baseline.
  sorted   sort the (token, choice) pairs by expert id, find each expert's
           segment with ``lower_bound(sorted_ids, e)`` (the paper's
           operation, here `torch.searchsorted`), gather the tokens into
           ``[E, C]`` capacity slots and run one batched product a weight
           stack.  Pairs past an expert's capacity ``C`` are dropped.

Both share the router and its losses (Switch load balance + router z).

Gathers only.  The sorted dispatch moves rows between token, sorted and
slot order with four permutations (`SortedToSlots`, `SlotsToSorted`,
`TokensToSorted`, `SortedToTokens`), each an ``autograd.Function`` whose
backward is the mirror gather, as the reference's custom VJPs pin it
(`src/repro/models/moe.py:129-219`): autograd would otherwise transpose a
gather into a scatter-add.

Ties.  The reference's ``jnp.argsort`` is stable, so pairs routed to one
expert keep token order and, under capacity, the earliest tokens are
kept; the port sorts with ``stable=True`` for the same choice.
``lax.top_k`` gives exact ties in the router's probabilities to the lower
expert id; ``torch.topk`` promises no order for ties, so the port takes
its top k from a stable descending sort, which gives them to the lower id
too.

Groups.  The tokens are dispatched in groups, one a data shard
(`_n_groups`: `repro_torch.dist.sharding.dispatch_groups`, halved until
it divides the token count), each with its own sort, segments and
capacity, as the reference dispatches them; with no `axis_rules` context
that is one group.  Capacity drops depend on the group count, so an
n-rank data-parallel step equals the one-rank step run with n groups:
each rank's tokens are one group, and the router's dispatch fractions
are averaged over the ranks (`batch_mean`), so that its load-balance
loss is the global batch's, as the reference's is.
The reference's sharding annotations have no counterpart here: each rank
runs the layer on its local tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.sharding import batch_mean, dispatch_groups
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import silu


def init_moe(cfg: ModelConfig, init) -> nn.ParameterDict:
    """The reference's ``init_moe`` shapes and scales (the router in
    float32); ``init`` is the decoder's initialiser
    (`transformer._Init`)."""
    d, h, e = cfg.d_model, cfg.moe_hidden, cfg.n_experts
    s_in, s_out = d ** -0.5, h ** -0.5
    p = {"router": init.normal((d, e), s_in, torch.float32),
         "wi": init.normal((e, d, h), s_in),
         "wg": init.normal((e, d, h), s_in),
         "wo": init.normal((e, h, d), s_out)}
    if cfg.n_shared_experts:
        hs = h * cfg.n_shared_experts
        p.update(shared_wi=init.normal((d, hs), s_in),
                 shared_wg=init.normal((d, hs), s_in),
                 shared_wo=init.normal((hs, d), s_out))
    return nn.ParameterDict(p)



def moe_specs(cfg: ModelConfig) -> dict:
    """Logical axis names of `init_moe`'s parameters (the reference's
    ``moe_specs``): the expert weights shard their hidden dim
    (``expert_fsdp``), never the contraction dim ``embed``."""
    p = {
        "router": ("embed", "experts"),
        "wi": ("experts", None, "expert_fsdp"),
        "wg": ("experts", None, "expert_fsdp"),
        "wo": ("experts", "expert_fsdp", None),
    }
    if cfg.n_shared_experts:
        p["shared_wi"] = ("embed", "mlp")
        p["shared_wg"] = ("embed", "mlp")
        p["shared_wo"] = ("mlp", "embed")
    return p

def _router(cfg: ModelConfig, p, x):
    """x [T, d] -> (top-k probs [T, k], top-k ids [T, k] int64, aux)."""
    logits = torch.einsum("td,de->te", x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :cfg.top_k], top_i[:, :cfg.top_k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    # Switch load-balance loss: E * sum_e f_e * p_e, on the first choice;
    # f over the global batch (`batch_mean`: every data rank's tokens)
    e = cfg.n_experts
    f = batch_mean(F.one_hot(top_i[:, 0], e).float().mean(0))
    aux = e * torch.sum(f * probs.mean(0)) * cfg.aux_loss_coef
    z = torch.logsumexp(logits, dim=-1).square().mean() * cfg.router_z_coef
    return top_p, top_i, aux + z


def _expert_ffn(cfg: ModelConfig, p, xs):
    """xs [G, E, C, d] -> [G, E, C, d]: one batched product a stack."""
    h = torch.einsum("gecd,edf->gecf", xs, p["wi"])
    g = torch.einsum("gecd,edf->gecf", xs, p["wg"])
    return torch.einsum("gecf,efd->gecd", silu(g) * h, p["wo"])


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots an expert holds for a group of ``tokens`` (the reference's
    rounding: the factor's share, up to a multiple of 8, at least 8)."""
    cap = int(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts)
    return max(8, ((cap + 7) // 8) * 8)


def _rows(x, index):
    """``x[g, index[g, j]]`` for x [G, N, D] and index [G, J]."""
    return torch.gather(x, 1, index[..., None].expand(-1, -1, x.shape[-1]))


def _pad_row(x):
    """A zero row after the last of axis 1."""
    return F.pad(x, (0, 0, 0, 1))


class SortedToSlots(torch.autograd.Function):
    """``[G, J+1, D]`` sorted rows (row J zero) -> ``[G, S, D]`` slots;
    backward: the slots' cotangent gathered back by ``flat_slot``, zero
    where ``keep`` is false, a zero pad row."""

    @staticmethod
    def forward(ctx, vs_pad, inv_slot, flat_slot, keep):
        ctx.save_for_backward(flat_slot, keep)
        return _rows(vs_pad, inv_slot)

    @staticmethod
    def backward(ctx, ct):
        flat_slot, keep = ctx.saved_tensors
        d = _rows(ct, flat_slot) * keep[..., None].to(ct.dtype)
        return _pad_row(d), None, None, None


class SlotsToSorted(torch.autograd.Function):
    """``[G, S, D]`` slots -> ``[G, J, D]`` sorted rows (dropped rows
    zero); backward: the cotangent, masked and padded, gathered by
    ``inv_slot``."""

    @staticmethod
    def forward(ctx, ys, inv_slot, flat_slot, keep):
        ctx.save_for_backward(inv_slot, keep)
        return _rows(ys, flat_slot) * keep[..., None].to(ys.dtype)

    @staticmethod
    def backward(ctx, ct):
        inv_slot, keep = ctx.saved_tensors
        ct_pad = _pad_row(ct * keep[..., None].to(ct.dtype))
        return _rows(ct_pad, inv_slot), None, None, None


class TokensToSorted(torch.autograd.Function):
    """``[G, T, D]`` tokens -> ``[G, J = T*k, D]`` sorted rows; backward:
    the cotangent gathered back to (token, choice) order by ``inv_perm``
    and summed over the ``k`` choices."""

    @staticmethod
    def forward(ctx, k, xg, tok_sorted, inv_perm):
        ctx.k = k
        ctx.save_for_backward(inv_perm)
        return _rows(xg, tok_sorted)

    @staticmethod
    def backward(ctx, ct):
        (inv_perm,) = ctx.saved_tensors
        g, j, d = ct.shape
        un = _rows(ct, inv_perm).reshape(g, j // ctx.k, ctx.k, d)
        return None, un.sum(2), None, None


class SortedToTokens(torch.autograd.Function):
    """``[G, J, D]`` sorted rows -> ``[G, T, D]`` tokens, the ``k``
    choices of a token summed; backward: the cotangent gathered by
    ``tok_sorted``."""

    @staticmethod
    def forward(ctx, k, vs, tok_sorted, inv_perm):
        ctx.save_for_backward(tok_sorted)
        g, j, d = vs.shape
        return _rows(vs, inv_perm).reshape(g, j // k, k, d).sum(2)

    @staticmethod
    def backward(ctx, ct):
        (tok_sorted,) = ctx.saved_tensors
        return None, _rows(ct, tok_sorted), None, None


def _n_groups(t: int) -> int:
    """Dispatch groups = data shards (1 without a mesh), halved until
    they divide the ``t`` tokens (the reference's ``_n_groups``)."""
    g = dispatch_groups(t)
    while t % g:
        g //= 2
    return max(g, 1)


def sorted_dispatch_plan(cfg: ModelConfig, top_i, groups: int = 1):
    """The sorted dispatch's index arithmetic for top-k ids ``[T, k]``
    in ``groups`` groups of ``T / groups`` consecutive tokens: a dict of
    ``order``, ``inv_perm``, ``e_sorted``, ``tok_sorted``, ``seg_start``,
    ``keep``, ``flat_slot``, ``inv_slot`` (each ``[groups, ...]``) and
    ``cap``, the slots an expert holds in a group."""
    t, k = top_i.shape
    g, e = groups, cfg.n_experts
    j = t // g * k
    cap = capacity(cfg, t // g)
    dev = top_i.device
    eg = top_i.reshape(g, j)
    order = torch.argsort(eg, dim=-1, stable=True)    # sort pairs by expert
    inv_perm = torch.argsort(order, dim=-1)           # a permutation: no ties
    e_sorted = torch.gather(eg, -1, order)
    tok_sorted = order // k                           # token of sorted entry
    # the paper's operation: segment starts = lower_bound(e_sorted, e)
    experts = torch.arange(e, device=dev).expand(g, e).contiguous()
    seg_start = torch.searchsorted(e_sorted, experts)
    seg_end = torch.searchsorted(e_sorted, experts, right=True)
    pos_in_seg = (torch.arange(j, device=dev)[None]
                  - torch.gather(seg_start, -1, e_sorted))
    keep = pos_in_seg < cap
    flat_slot = torch.where(
        keep, e_sorted * cap + torch.clamp(pos_in_seg, max=cap - 1), 0)
    # slot -> sorted position, arithmetically (j marks an empty slot)
    islot = seg_start[:, :, None] + torch.arange(cap, device=dev)[None, None]
    valid = islot < torch.minimum(seg_end, seg_start + cap)[:, :, None]
    inv_slot = torch.where(valid, islot, j).reshape(g, e * cap)
    return dict(order=order, inv_perm=inv_perm, e_sorted=e_sorted,
                tok_sorted=tok_sorted, seg_start=seg_start, keep=keep,
                flat_slot=flat_slot, inv_slot=inv_slot, cap=cap)


def _dispatch_sorted(cfg: ModelConfig, p, x2d):
    """Sort-by-expert dispatch with capacity, in `_n_groups` groups."""
    t, d = x2d.shape
    e, k = cfg.n_experts, cfg.top_k
    g = _n_groups(t)
    tl = t // g                                       # tokens a group
    top_p, top_i, aux = _router(cfg, p, x2d)
    plan = sorted_dispatch_plan(cfg, top_i, g)
    cap = plan["cap"]
    p_sorted = torch.gather(top_p.reshape(g, tl * k), -1, plan["order"])

    slots = plan["inv_slot"], plan["flat_slot"], plan["keep"]
    perm = plan["tok_sorted"], plan["inv_perm"]

    # dispatch: tokens -> sorted -> slots, a zero row for the empty slots
    xs_sorted = TokensToSorted.apply(k, x2d.reshape(g, tl, d), *perm)
    xs = SortedToSlots.apply(_pad_row(xs_sorted), *slots).reshape(
        g, e, cap, d)

    ys = _expert_ffn(cfg, p, xs)

    # combine: slots -> sorted (weighted, dropped rows zero) -> tokens
    ys_sorted = SlotsToSorted.apply(ys.reshape(g, e * cap, d), *slots)
    ys_sorted = ys_sorted * p_sorted[..., None].to(ys_sorted.dtype)
    out = SortedToTokens.apply(k, ys_sorted, *perm).reshape(t, d)
    return out, aux


def _dispatch_dense(cfg: ModelConfig, p, x2d):
    """Baseline: every expert computes every token; mask-combine."""
    t, d = x2d.shape
    e = cfg.n_experts
    g = _n_groups(t)
    top_p, top_i, aux = _router(cfg, p, x2d)
    xs = x2d.reshape(g, 1, t // g, d).expand(g, e, t // g, d)
    ys = _expert_ffn(cfg, p, xs)                      # [G, E, T/G, d]
    ys = ys.permute(1, 0, 2, 3).reshape(e, t, d)      # [E, T, d]
    combine = torch.zeros((t, e), dtype=torch.float32, device=x2d.device)
    combine.scatter_(1, top_i, top_p)                 # [T, E]
    out = torch.einsum("etd,te->td", ys, combine.to(ys.dtype))
    return out, aux


def moe_ffn(cfg: ModelConfig, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (out [B, S, d], aux loss, a float32 scalar)."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    if cfg.moe_dispatch == "dense":
        out, aux = _dispatch_dense(cfg, p, x2d)
    else:
        out, aux = _dispatch_sorted(cfg, p, x2d)
    if cfg.n_shared_experts:
        h = torch.einsum("td,df->tf", x2d, p["shared_wi"])
        g = torch.einsum("td,df->tf", x2d, p["shared_wg"])
        out = out + torch.einsum("tf,fd->td", silu(g) * h, p["shared_wo"])
    return out.reshape(b, s, d), aux
