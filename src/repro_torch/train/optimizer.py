"""AdamW with decoupled weight decay, and the cosine schedule, as the
reference's `repro.train.optimizer`, in plain torch ops.

Not `torch.optim.AdamW`: the reference clips by the global gradient norm
first, bias-corrects with the incremented step, and adds the decay to the
normalized step before scaling by the learning rate, in this order:

  gnorm = sqrt(sum over leaves of sum(g.f32 ** 2))
  scale = min(1, clip / max(gnorm, 1e-9))
  step + 1, then c1 = 1 - b1 ** step, c2 = 1 - b2 ** step, lr(step)
  g = g.f32 * scale;  m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
  delta = (m / c1) / (sqrt(v / c2) + eps) + wd * p.f32
  p = (p.f32 - lr * delta) cast to p's type

The moments are float32, one a parameter, in the parameters' order.
``update`` writes the new parameters and moments in place (the reference
returns new arrays; a full-width model has no room for two copies) and
returns a new ``step``.  A data-parallel rank passes the global
gradient norm (``gnorm``, reduced over every rank's shards) and updates
its local shards.  ``opt_state_specs`` names the moments' axes as the
parameters' (`repro_torch.dist.sharding` places them alike).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor              # int32 scalar
    m: List[torch.Tensor]
    v: List[torch.Tensor]


def _tensors(params) -> List[torch.Tensor]:
    """An ``nn.Module``'s parameters, or a sequence of tensors, as a
    list."""
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    return list(params)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        ps = _tensors(params)
        m = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in ps]
        return AdamWState(
            torch.zeros((), dtype=torch.int32, device=ps[0].device), m,
            [t.clone() for t in m])

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, gnorm=None):
        """One step: ``(params, new state, gnorm)``, the parameters and
        moments updated in place; ``gnorm`` defaults to the norm of
        ``grads``."""
        ps = _tensors(params)
        step = state.step + 1
        if gnorm is None:
            gnorm = torch.sqrt(sum_of_squares(grads))
        scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        b1, b2 = self.b1, self.b2
        sf = step.float()
        c1 = 1.0 - torch.pow(b1, sf)
        c2 = 1.0 - torch.pow(b2, sf)
        lr = self.lr(step)
        for p, g, m, v in zip(ps, grads, state.m, state.v):
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            delta = delta + self.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
        return params, AdamWState(step, state.m, state.v), gnorm


def sum_of_squares(grads) -> torch.Tensor:
    """sum over tensors of sum(g.f32 ** 2): the squared gradient norm."""
    return sum(torch.sum(torch.square(g.float())) for g in grads)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    """``lr(step)``: linear warm-up to ``peak_lr`` over ``warmup`` steps,
    then a cosine down to ``floor_frac * peak_lr`` at ``total``, in
    float32."""

    def lr(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)

    return lr


def opt_state_specs(param_specs_tree):
    """Logical names for an `AdamWState` over parameters named by
    ``param_specs_tree`` (`repro_torch.models.model.param_specs`, in
    parameter order): the step is a scalar, each moment takes its
    parameter's names."""
    names = list(param_specs_tree.values())
    return AdamWState(step=(), m=names, v=list(names))
