"""Train step: loss -> gradients -> AdamW, with microbatch accumulation,
as the reference's `repro.train.train_step`.

One device: the gradient is ``torch.autograd.grad`` of
`models.model.loss_fn`.  With ``microbatches > 1`` the batch is split
along its first axis and the per-microbatch mean losses and gradients are
summed in float32, then divided by the count, as the reference's scan
does.

Data parallel (`DataParallel`): ZeRO-style sharding of the moments and
the gradients, not FSDP storage.  Each rank of the ``data`` dim of an
``(n, 1)`` mesh holds its slice of the global batch, the whole model,
and, for every parameter, the block that
`repro_torch.dist.sharding.resolve_spec` places on it under the
parameter rules (a view of the parameter) with that block's AdamW
moments; a parameter the rules do not shard over ``data`` is whole on
every rank.  A step all-gathers the other ranks' blocks into the model,
runs the forward and backward on the rank's batch, reduce-scatters the
gradients (in float32) to the blocks, reduces the squared gradient norm
over every rank, and updates the local blocks.  The collectives go in
buckets of many parameters.  The loss divides by the unmasked labels of
every rank's batch (all-reduced first), and each rank adds 1/n of the
MoE aux loss, whose dispatch fractions are the global batch's
(`sharding.local_shard`, carried into a `remat` recomputation), so the
ranks' losses sum to the global batch's.  A rank's tokens are one MoE
dispatch group, so n ranks equal one device run with n groups.  At one
rank every value equals the one-device step's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from repro_torch.dist import sharding as SH
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import AdamW, AdamWState, sum_of_squares


@dataclasses.dataclass
class TrainState:
    params: Any                    # the model (an nn.Module)
    opt: AdamWState


def _loss_and_grads(cfg: ModelConfig, params, batch, microbatches: int,
                    counts=None, aux_scale: float = 1.0):
    """The batch's loss and gradients (microbatches accumulated in
    float32); ``counts[i]`` is microbatch i's unmasked-label count (None:
    its own)."""
    ps = list(params.parameters())

    def grads_of(b, count):
        loss = M.loss_fn(cfg, params, b, count, aux_scale)
        grads = torch.autograd.grad(loss, ps, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), grads

    if microbatches == 1:
        return grads_of(batch, None if counts is None else counts[0])
    mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                       *v.shape[1:]) for k, v in batch.items()}
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in ps]
    loss = torch.zeros((), dtype=torch.float32, device=ps[0].device)
    for i in range(microbatches):
        mb_loss, g = grads_of({k: v[i] for k, v in mb.items()},
                              None if counts is None else counts[i])
        for acc, gi in zip(grads, g):
            acc.add_(gi.float())
        loss = loss + mb_loss
    return loss / microbatches, [g / microbatches for g in grads]


def make_train_step(cfg: ModelConfig, opt: AdamW, microbatches: int = 1):
    """``train_step(state, batch) -> (state, metrics)``; ``metrics`` holds
    ``loss``, ``grad_norm`` and ``lr`` (at the new step) as 0-d tensors on
    the state's device.  The state's tensors are updated in place."""

    def step(state: TrainState, batch):
        loss, grads = _loss_and_grads(cfg, state.params, batch, microbatches)
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


# ---------------------------------------------------------------------------
# data parallel
# ---------------------------------------------------------------------------
#: a bucket of the data-parallel step's collectives closes once it holds
#: this many parameter elements (a larger parameter is a bucket alone)
BUCKET_NUMEL = 1 << 26


@dataclasses.dataclass
class ShardedTrainState:
    """A data-parallel rank's state: ``params`` is the full-shape model,
    whole on every rank; ``shards[i]`` is parameter i's local block, a
    view of it (the parameter itself where it is not sharded); ``opt``
    holds the moments of those blocks."""
    params: Any
    opt: AdamWState
    shards: List[torch.Tensor]


class DataParallel:
    """Moment and gradient sharding over the ``data`` dim of ``mesh`` (a
    DeviceMesh whose other dims have size 1), and its step.

    ``dims[i]`` is the tensor dim of parameter i that the config's
    parameter rules (`sharding.select_rules`) shard over ``data``, or None
    where they shard none; ``buckets`` groups the parameters for the
    collectives (sharded and whole apart, one dtype a bucket, closed once
    it holds BUCKET_NUMEL elements)."""

    def __init__(self, cfg: ModelConfig, opt: AdamW, mesh,
                 microbatches: int = 1):
        sizes = SH._mesh_shape(mesh)
        if any(n > 1 for a, n in sizes.items() if a != "data"):
            raise ValueError(f"data parallel needs a mesh with one "
                             f"non-trivial dim, 'data'; got {sizes}")
        self.cfg, self.opt, self.mesh = cfg, opt, mesh
        self.microbatches = microbatches
        self.group = mesh.get_group("data")
        self.n, self.rank = sizes["data"], mesh.get_local_rank("data")
        self.param_rules = SH.select_rules(cfg)[1]
        self.dims: Optional[List[Optional[int]]] = None
        self.buckets: Optional[List[List[int]]] = None

    def shard_dims(self, params) -> List[Optional[int]]:
        specs = M.param_specs(self.cfg)
        dims = []
        for name, p in params.named_parameters():
            spec = SH.resolve_spec(tuple(p.shape), specs[name], self.mesh,
                                   self.param_rules)
            dims.append(next((d for d, e in enumerate(spec)
                              if e is not None), None))
        return dims

    def _block(self, full, d):
        return full.chunk(self.n, d)[self.rank]

    def init(self, params) -> ShardedTrainState:
        """Take ``params`` (the same full values on every rank), view this
        rank's blocks and zero their moments."""
        self.dims = self.shard_dims(params)
        ps = list(params.parameters())
        self.buckets, open_ = [], {}
        for i, (p, d) in enumerate(zip(ps, self.dims)):
            key = (d is None, p.dtype)
            if key not in open_:
                open_[key] = [[], 0]
                self.buckets.append(open_[key][0])
            open_[key][0].append(i)
            open_[key][1] += p.numel()
            if open_[key][1] >= BUCKET_NUMEL:
                del open_[key]
        shards = [p.data if d is None else self._block(p.data, d)
                  for p, d in zip(ps, self.dims)]
        return ShardedTrainState(params, self.opt.init(shards), shards)

    def _sharded(self):
        return [b for b in self.buckets if self.dims[b[0]] is not None]

    @torch.no_grad()
    def _gather(self, outs, blocks, bucket) -> None:
        """``outs[i]`` (full shape) <- every rank's ``blocks[i]`` along dim
        ``dims[i]``, for i in ``bucket``: one all-gather."""
        moved = [blocks[i].movedim(self.dims[i], 0) for i in bucket]
        send = torch.cat([m.reshape(-1) for m in moved])
        recv = send.new_empty(self.n * send.numel())
        dist.all_gather_into_tensor(recv, send, group=self.group)
        recv = recv.view(self.n, -1)
        o = 0
        for i, m in zip(bucket, moved):
            out = outs[i].movedim(self.dims[i], 0)
            out.unflatten(0, (self.n, m.shape[0])).copy_(
                recv[:, o:o + m.numel()].view(self.n, *m.shape))
            o += m.numel()

    def gather_params(self, state: ShardedTrainState) -> None:
        """The model's sharded parameters <- the ranks' current blocks."""
        ps = [p.data for p in state.params.parameters()]
        for b in self._sharded():
            self._gather(ps, state.shards, b)

    @torch.no_grad()
    def _reduce(self, grads, bucket) -> None:
        """``grads[i]`` <- the sum over ranks of it in float32, for i in
        ``bucket``: this rank's block along dim ``dims[i]`` (one
        reduce-scatter), or the whole where the bucket is not sharded
        (one all-reduce)."""
        if self.dims[bucket[0]] is None:
            # each keeps its layout (a tied embedding's gradient is
            # transposed), so its norm sums in the one-device step's order
            gs = [grads[i].float() for i in bucket]
            flat = torch.cat([g.reshape(-1) for g in gs])
            dist.all_reduce(flat, group=self.group)
            o = 0
            for i, g in zip(bucket, gs):
                grads[i] = g.copy_(flat[o:o + g.numel()].view(g.shape))
                o += g.numel()
            return
        moved = [grads[i].movedim(self.dims[i], 0) for i in bucket]
        k = [m.numel() // self.n for m in moved]
        send = torch.empty((self.n, sum(k)), dtype=torch.float32,
                           device=moved[0].device)
        o = 0
        for m, ki in zip(moved, k):
            send[:, o:o + ki].view(self.n, -1, *m.shape[1:]).copy_(
                m.unflatten(0, (self.n, -1)))
            o += ki
        out = send.new_empty(sum(k))
        dist.reduce_scatter_tensor(out, send.view(-1), group=self.group)
        o = 0
        for i, m, ki in zip(bucket, moved, k):
            grads[i] = out[o:o + ki].view(-1, *m.shape[1:]).movedim(
                0, self.dims[i])
            o += ki

    def step(self, state: ShardedTrainState, batch):
        """One data-parallel step on this rank's ``batch``; metrics as
        `make_train_step`'s, over the global batch."""
        self.gather_params(state)
        m = self.microbatches
        labels = batch["labels"]
        counts = (labels >= 0).reshape(m, -1).sum(1).float()
        dist.all_reduce(counts, group=self.group)
        # each rank's tokens are one data shard: one MoE dispatch group,
        # whose router statistics average over the ranks
        with SH.local_shard(self.group):
            loss, grads = _loss_and_grads(self.cfg, state.params, batch, m,
                                          counts, 1.0 / self.n)
        grads = list(grads)
        for b in self.buckets:
            self._reduce(grads, b)
        # a parameter held whole counts once, on rank 0
        sq = sum_of_squares(g for g, d in zip(grads, self.dims)
                            if d is not None or self.rank == 0)
        sq = torch.zeros((), dtype=torch.float32, device=labels.device) + sq
        dist.all_reduce(sq, group=self.group)
        dist.all_reduce(loss, group=self.group)
        _, opt_state, gnorm = self.opt.update(grads, state.opt, state.shards,
                                              gnorm=torch.sqrt(sq))
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": self.opt.lr(opt_state.step)}
        return ShardedTrainState(state.params, opt_state, state.shards), \
            metrics

    @torch.no_grad()
    def full_state(self, state: ShardedTrainState) -> TrainState:
        """The whole state as one device holds it (the checkpoint's
        format): the model gathered, each moment gathered into a new
        full-shape tensor."""
        self.gather_params(state)
        ps = list(state.params.parameters())

        def full(blocks):
            out = [b if d is None else b.new_empty(p.shape)
                   for b, p, d in zip(blocks, ps, self.dims)]
            for b in self._sharded():
                self._gather(out, blocks, b)
            return out

        o = state.opt
        return TrainState(state.params,
                          AdamWState(o.step, full(o.m), full(o.v)))

    @torch.no_grad()
    def load(self, state: ShardedTrainState, full: TrainState) -> None:
        """Take this rank's blocks of ``full`` (a whole state whose model
        is the one of ``state``, its blocks views of it) into ``state``,
        in place."""
        state.opt.step.copy_(full.opt.step)
        for i, d in enumerate(self.dims):
            for mine, whole in ((state.opt.m[i], full.opt.m[i]),
                                (state.opt.v[i], full.opt.v[i])):
                mine.copy_(whole if d is None else self._block(whole, d))
