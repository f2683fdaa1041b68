"""Train step: loss -> gradients -> AdamW, with microbatch accumulation,
as the reference's `repro.train.train_step`.

One device: the gradient is ``torch.autograd.grad`` of
`models.model.loss_fn`.  With ``microbatches > 1`` the batch is split
along its first axis and the per-microbatch mean losses and gradients are
summed in float32, then divided by the count, as the reference's scan
does.

Data parallel (`DataParallel`): FSDP storage, as the reference's train
driver places its parameters (``shard_tree(param_specs)`` under the
parameter rules).  Each rank of the ``data`` dim of an ``(n, 1)`` mesh
holds its slice of the global batch and, for every parameter, the block
that `repro_torch.dist.sharding.resolve_spec` places on it, with that
block's AdamW moments; the model's full-shape parameter holds no storage.
A parameter the rules leave whole (the embedding, the norms) is whole on
every rank.  The forward gathers one unit at a time (`sharding.gathered`:
a prologue block, a scanned unit, the embedding with the final norm): one
all-gather before the unit runs, freed after it.  The backward gathers
the unit again (at the first unpack of a weight the forward saved, or in
`remat`'s recomputation) and, once every gradient of the unit exists,
reduce-scatters them in float32 into this rank's blocks, one collective a
unit.  Whole parameters' gradients are all-reduced after the backward;
the squared gradient norm is summed over every rank, and each rank
updates its blocks.  The loss divides by the unmasked labels of every
rank's batch (all-reduced first), and each rank adds 1/n of the MoE aux
loss, whose dispatch fractions are the global batch's
(`sharding.local_shard`, carried into a `remat` recomputation), so the
ranks' losses sum to the global batch's.  A rank's tokens are one MoE
dispatch group, so n ranks equal one device run with n groups.  At one
rank nothing is sharded and every value equals the one-device step's bit
for bit.
"""
from __future__ import annotations

import dataclasses
import weakref
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
                    counts=None, aux_scale: float = 1.0, inputs=None):
    """The batch's loss and gradients (microbatches accumulated in
    float32) with respect to ``inputs`` (default: every parameter);
    ``counts[i]`` is microbatch i's unmasked-label count (None: its
    own)."""
    ps = list(params.parameters() if inputs is None else inputs)

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
@dataclasses.dataclass
class ShardedTrainState:
    """A data-parallel rank's state: ``params`` is the model, whose
    sharded parameters keep their full shape but hold no storage outside
    a step; ``shards[i]`` is parameter i's block on this rank (its own
    tensor), or the parameter itself where it is not sharded; ``opt``
    holds the moments of those blocks."""
    params: Any
    opt: AdamWState
    shards: List[torch.Tensor]


class _Unshard(torch.autograd.Function):
    """A unit's sharded parameters gathered whole, one all-gather.  Its
    backward runs once every gradient of those parameters exists (the
    engine waits for each output's), on whatever thread runs the
    backward; it reduce-scatters them into the step's blocks.  The
    gradient it passes on, to the store's anchor, is none."""

    @staticmethod
    def forward(ctx, unit, anchor):
        ctx.unit = unit
        return tuple(unit.dp._gather(unit.dp._blocks, unit.idx))

    @staticmethod
    def backward(ctx, *grads):
        ctx.unit.again = None
        ctx.unit.dp._reduce(ctx.unit.idx, grads)
        return None, None


class _Unit:
    """One run of a unit: its sharded parameters (indices) and, for the
    backward, the weights gathered again.  Its saved-tensor hooks pack a
    gathered weight (or a view of one) as its index and geometry, so the
    forward keeps no gathered storage; the first unpack gathers the unit
    again, and `_Unshard`'s backward drops it."""

    def __init__(self, dp: "DataParallel", idx: List[int]):
        self.dp, self.idx = dp, idx
        self.ptrs = {}
        self.again = None

    def pack(self, t):
        k = self.ptrs.get(t.untyped_storage().data_ptr())
        if k is None or t.dtype != self.dp._params[self.idx[k]].dtype:
            return t
        return k, t.size(), t.stride(), t.storage_offset()

    def unpack(self, packed):
        if isinstance(packed, torch.Tensor):
            return packed
        if self.again is None:
            self.again = self.dp._gather(self.dp._blocks, self.idx)
        k, size, stride, offset = packed
        return self.again[k].as_strided(size, stride, offset)


class DataParallel:
    """FSDP storage over the ``data`` dim of ``mesh`` (a DeviceMesh whose
    other dims have size 1), and its step.

    ``dims[i]`` is the tensor dim of parameter i that the config's
    parameter rules (`sharding.select_rules`) shard over ``data``, or None
    where they shard none.  The step installs this object as the
    context's parameter store (`sharding.local_shard`), whose `run_unit`
    the model's units call.

    Why an autograd function a unit and saved-tensor hooks: the step
    takes gradients with ``torch.autograd.grad``, under which no
    ``.grad`` accumulation hook fires.  The function's backward is the
    one point where every gradient of the unit exists, with no counting,
    and its gradients never reach ``autograd.grad``'s result (which would
    hold every full gradient at once): the blocks go to the step's
    buffers, and ``autograd.grad`` is asked only for the whole parameters
    and an anchor that carries no value.  A unit's gathered weights are
    reached again by what its backward unpacks, on autograd's thread, so
    the hooks need no thread-local state; a `remat` recomputation runs
    the unit again under the sharding context its forward saved."""

    def __init__(self, cfg: ModelConfig, opt: AdamW, mesh,
                 microbatches: int = 1):
        sizes = SH._mesh_shape(mesh)
        if any(n > 1 for a, n in sizes.items() if a != "data"):
            raise ValueError(f"data parallel needs a mesh with one "
                             f"non-trivial dim, 'data'; got {sizes}")
        if cfg.family == "encdec":
            raise ValueError(f"{cfg.name}: data parallel gathers the "
                             f"decoder's units; the encdec family has none")
        self.cfg, self.opt, self.mesh = cfg, opt, mesh
        self.microbatches = microbatches
        self.group = mesh.get_group("data")
        self.n, self.rank = sizes["data"], mesh.get_local_rank("data")
        self.param_rules = SH.select_rules(cfg)[1]
        self.dims: Optional[List[Optional[int]]] = None
        #: the most bytes of gathered weights alive at once since the last
        #: step began (weakly tracked storages, read at each gather)
        self.gathered_peak_bytes = 0
        self._blocks = self._acc = None
        self._live: list = []

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

    @torch.no_grad()
    def init(self, params) -> ShardedTrainState:
        """Take ``params`` (the same whole model on every rank): copy this
        rank's block of each sharded parameter and free the parameter's
        storage, one parameter at a time, then zero the blocks'
        moments."""
        named = list(params.named_parameters())
        self.dims = self.shard_dims(params)
        self._params = [p for _, p in named]
        self._pos = {id(p): i for i, p in enumerate(self._params)}
        self._slots = [(params.get_submodule(owner), attr) for owner, _, attr
                       in (n.rpartition(".") for n, _ in named)]
        shards = []
        for p, d in zip(self._params, self.dims):
            if d is None:
                shards.append(p.data)
                continue
            if p.untyped_storage().nbytes() != p.numel() * p.element_size():
                raise ValueError("data parallel frees each sharded "
                                 "parameter's storage: it must hold that "
                                 "parameter alone")
            shards.append(self._block(p.data, d).clone())
            p.untyped_storage().resize_(0)
        self._anchor = torch.zeros((), device=self._params[0].device,
                                   requires_grad=True)
        return ShardedTrainState(params, self.opt.init(shards), shards)

    def param_bytes(self, state: ShardedTrainState) -> int:
        """The parameter bytes this rank stores: the model's parameters'
        storage and the sharded blocks."""
        return sum(p.untyped_storage().nbytes()
                   for p in state.params.parameters()) + sum(
            b.untyped_storage().nbytes()
            for b, d in zip(state.shards, self.dims) if d is not None)

    def run_unit(self, modules, fn, saved: bool, args):
        """``fn(*args)`` with the sharded parameters of ``modules``
        gathered (`sharding.gathered`): the model's entries point at the
        gathered tensors while it runs."""
        idx = [i for m in modules for p in m.parameters()
               if (i := self._pos.get(id(p))) is not None
               and self.dims[i] is not None]
        if not idx:
            return fn(*args)
        unit = _Unit(self, idx)
        full = _Unshard.apply(unit, self._anchor)
        for i, t in zip(idx, full):
            owner, attr = self._slots[i]
            owner._parameters[attr] = t
        try:
            if not (saved and torch.is_grad_enabled()):
                return fn(*args)
            unit.ptrs = {t.untyped_storage().data_ptr(): k
                         for k, t in enumerate(full)}
            with torch.autograd.graph.saved_tensors_hooks(unit.pack,
                                                          unit.unpack):
                return fn(*args)
        finally:
            for i in idx:
                owner, attr = self._slots[i]
                owner._parameters[attr] = self._params[i]

    @torch.no_grad()
    def _gather(self, blocks, idx) -> List[torch.Tensor]:
        """The full tensors of ``blocks[i]`` for i in ``idx``, every rank's
        block along dim ``dims[i]``: one all-gather."""
        moved = [blocks[i].movedim(self.dims[i], 0) for i in idx]
        send = torch.cat([m.reshape(-1) for m in moved])
        recv = send.new_empty(self.n * send.numel())
        dist.all_gather_into_tensor(recv, send, group=self.group)
        recv = recv.view(self.n, -1)
        out, o = [], 0
        for i, m in zip(idx, moved):
            full = m.new_empty(self._params[i].shape)
            full.movedim(self.dims[i], 0).unflatten(
                0, (self.n, m.shape[0])).copy_(
                recv[:, o:o + m.numel()].view(self.n, *m.shape))
            o += m.numel()
            out.append(full)
        self._live = [(r, b) for r, b in self._live if r() is not None]
        self._live += [(weakref.ref(t.untyped_storage()),
                        t.untyped_storage().nbytes()) for t in out]
        self.gathered_peak_bytes = max(self.gathered_peak_bytes,
                                       sum(b for _, b in self._live))
        return out

    @torch.no_grad()
    def _reduce(self, idx, grads) -> None:
        """Add the sum over ranks of a unit's gradients ``grads`` (of
        parameters ``idx``), in float32, to the step's blocks: this rank's
        block along dim ``dims[i]``, one reduce-scatter."""
        moved = [g.movedim(self.dims[i], 0) for i, g in zip(idx, grads)]
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
        for i, m, ki in zip(idx, moved, k):
            g = out[o:o + ki].view(-1, *m.shape[1:]).movedim(0, self.dims[i])
            self._acc[i] = g if self._acc[i] is None else self._acc[i].add_(g)
            o += ki

    def step(self, state: ShardedTrainState, batch):
        """One data-parallel step on this rank's ``batch``; metrics as
        `make_train_step`'s, over the global batch."""
        m = self.microbatches
        labels = batch["labels"]
        counts = (labels >= 0).reshape(m, -1).sum(1).float()
        dist.all_reduce(counts, group=self.group)
        whole = [i for i, d in enumerate(self.dims) if d is None]
        self._blocks, self._acc = state.shards, [None] * len(self.dims)
        self._live, self.gathered_peak_bytes = [], 0
        # each rank's tokens are one data shard: one MoE dispatch group,
        # whose router statistics average over the ranks
        with SH.local_shard(self.group, self):
            loss, wgrads = _loss_and_grads(
                self.cfg, state.params, batch, m, counts, 1.0 / self.n,
                [self._params[i] for i in whole] + [self._anchor])
        grads, self._acc = self._acc, None
        for i, d in enumerate(self.dims):
            if d is not None and grads[i] is None:
                raise RuntimeError(f"parameter {i} is sharded but no unit "
                                   f"of the forward gathered it")
            if d is not None and m > 1:
                grads[i] = grads[i] / m
        # one all-reduce a whole gradient, each in float32 in its layout
        # (a tied embedding's is transposed), so the norm sums in the
        # one-device step's order; each model-type gradient is let go as
        # its float32 copy is made
        wgrads = list(wgrads[:-1])
        for j, i in enumerate(whole):
            g, wgrads[j] = wgrads[j].float(), None
            flat = g.reshape(-1)
            dist.all_reduce(flat, group=self.group)
            grads[i] = g.copy_(flat.view(g.shape))
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

    def host_state(self) -> TrainState:
        """An empty whole state on the host, in the checkpoint's tree: the
        model and both moments at full shape, the step."""
        model = M.init_params(self.cfg, device="meta").to_empty(device="cpu")
        m = [torch.empty(p.shape, dtype=torch.float32)
             for p in model.parameters()]
        return TrainState(model, AdamWState(
            torch.zeros((), dtype=torch.int32), m,
            [torch.empty_like(t) for t in m]))

    @torch.no_grad()
    def full_state(self, state: ShardedTrainState) -> Optional[TrainState]:
        """The whole state as one device holds it (the checkpoint's
        format), on rank 0's host, None on the other ranks.  Parameter by
        parameter: each sharded tensor (parameter, both moments) is
        all-gathered alone and copied to the host."""
        out = self.host_state() if self.rank == 0 else None
        srcs = (state.shards, state.opt.m, state.opt.v)
        if out is not None:
            dsts = (list(out.params.parameters()), out.opt.m, out.opt.v)
        for i, d in enumerate(self.dims):
            for k, src in enumerate(srcs):
                t = src[i] if d is None else self._gather(src, [i])[0]
                if out is not None:
                    dsts[k][i].copy_(t)
        if out is not None:
            out.opt.step.copy_(state.opt.step)
        return out

    @torch.no_grad()
    def load(self, state: ShardedTrainState, full: TrainState) -> None:
        """Take this rank's blocks of ``full`` (a whole state in
        `host_state`'s tree) into ``state``, in place."""
        state.opt.step.copy_(full.opt.step)
        for i, (p, d) in enumerate(zip(full.params.parameters(), self.dims)):
            for mine, whole in ((state.shards[i], p),
                                (state.opt.m[i], full.opt.m[i]),
                                (state.opt.v[i], full.opt.v[i])):
                mine.copy_(whole if d is None else self._block(whole, d))
