"""Train step: loss -> gradients -> AdamW, with microbatch accumulation,
as the reference's `repro.train.train_step`.

One device, no mesh: the gradient is ``torch.autograd.grad`` of
`models.model.loss_fn`.  With ``microbatches > 1`` the batch is split
along its first axis and the per-microbatch mean losses and gradients are
summed in float32, then divided by the count, as the reference's scan
does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import AdamW, AdamWState


@dataclasses.dataclass
class TrainState:
    params: Any                    # the model (an nn.Module)
    opt: AdamWState


def make_train_step(cfg: ModelConfig, opt: AdamW, microbatches: int = 1):
    """``train_step(state, batch) -> (state, metrics)``; ``metrics`` holds
    ``loss``, ``grad_norm`` and ``lr`` (at the new step) as 0-d tensors on
    the state's device.  The state's tensors are updated in place."""

    def grads_of(params, batch):
        ps = list(params.parameters())
        loss = M.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, ps, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), grads

    def step(state: TrainState, batch):
        if microbatches == 1:
            loss, grads = grads_of(state.params, batch)
        else:
            mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                               *v.shape[1:]) for k, v in batch.items()}
            ps = list(state.params.parameters())
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in ps]
            loss = torch.zeros((), dtype=torch.float32, device=ps[0].device)
            for i in range(microbatches):
                mb_loss, g = grads_of(state.params,
                                      {k: v[i] for k, v in mb.items()})
                for acc, gi in zip(grads, g):
                    acc.add_(gi.float())
                loss = loss + mb_loss
            loss = loss / microbatches
            grads = [g / microbatches for g in grads]
        params, opt_state, gnorm = opt.update(grads, state.opt, state.params)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": opt.lr(opt_state.step)}
        return TrainState(params, opt_state), metrics

    return step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        return M.loss_fn(cfg, params, batch)

    return eval_step
