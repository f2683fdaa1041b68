"""Run a function on several `torch.distributed` ranks of gloo on the
CPU, each a spawned process, for the port's distributed tests.

`run_ranks(fn, world, store)` starts ``world`` processes that join one
gloo group through a ``file://`` store (no TCP port, so parallel test
workers do not collide), call ``fn(rank, world, *args)`` and send back
its result.  Every wait is bounded: a hung rank fails the test in
seconds, and every child is killed before it returns.  The rank
functions live here, importing only torch, numpy and the port.
"""
from __future__ import annotations

import dataclasses
import queue
import traceback

import torch
import torch.multiprocessing as mp


def _entry(fn, rank, world, url, out, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=url, rank=rank,
                                world_size=world)
        try:
            out.put((rank, "ok", fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent
        out.put((rank, "error", traceback.format_exc()))


def run_ranks(fn, world: int, store: str, *args, timeout: float = 180.0):
    """``[fn(r, world, *args) for r in range(world)]``, one process a
    rank; raises with the rank's traceback if one fails or if they do not
    all answer within ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    url = f"file://{store}"
    procs = [ctx.Process(target=_entry, args=(fn, r, world, url, out, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, status, value = out.get(timeout=timeout)
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=30)
    except queue.Empty:
        raise RuntimeError(f"ranks did not answer within {timeout} s: "
                           f"got {sorted(results)}") from None
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(world)]


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------
def _cpu_mesh(shape, axes):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, axes)


def pipeline_rank(rank, world, mesh_shape, ws, x):
    """`pipeline_apply` of tanh(a @ w) over a ("data", "model") mesh."""
    from repro_torch.dist.pipeline_parallel import pipeline_apply

    mesh = _cpu_mesh(mesh_shape, ("data", "model"))
    out = pipeline_apply(lambda a, w: torch.tanh(a @ w),
                         torch.from_numpy(ws), torch.from_numpy(x), mesh)
    return out.numpy()


def compressed_rank(rank, world, xs, err):
    """`compressed_all_reduce` of this rank's ``xs[rank]``."""
    from repro_torch.dist.compression import compressed_all_reduce

    total, residual = compressed_all_reduce(
        torch.from_numpy(xs[rank]), None,
        None if err is None else torch.from_numpy(err[rank]))
    return total.numpy(), residual.numpy()


def constraint_rank(rank, world):
    """`logical_constraint` redistributes a DTensor as the context's rules
    place its names; a local tensor stays as it is."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.dist import sharding as SH

    mesh = _cpu_mesh((world, 1), ("data", "model"))
    full = torch.arange(8 * world * 6, dtype=torch.float32).reshape(
        8 * world, 6)
    x = distribute_tensor(full, mesh, [Replicate(), Replicate()])
    local = torch.ones(3)
    with SH.axis_rules(mesh):
        y = SH.logical_constraint(x, ("batch", None))
        same = SH.logical_constraint(local, ("batch",)) is local
        groups = SH.dispatch_groups()
    return (tuple(y.to_local().shape), [str(p) for p in y.placements],
            bool(torch.equal(y.full_tensor(), full)), same, groups)


def _smoke_f32(arch):
    from repro_torch.configs import get_smoke
    return dataclasses.replace(get_smoke(arch), dtype="float32")


def _opt(lr, steps):
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    return AdamW(lr=cosine_schedule(lr, warmup=10, total=steps))


def _pipe(cfg, seq, batch, rank, world):
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    return TokenPipeline(PipelineConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0,
        host_id=rank, n_hosts=world), device="cpu")


def _numpy_state(state):
    return {"params": {n: p.detach().numpy().copy()
                       for n, p in state.params.named_parameters()},
            "m": [t.numpy().copy() for t in state.opt.m],
            "v": [t.numpy().copy() for t in state.opt.v],
            "step": int(state.opt.step)}


def one_device_rank(rank, world, arch, steps, lr, seq, batch, microbatches,
                    groups=1):
    """The one-device run (`make_train_step`) in a rank's process, whose
    thread count the ranks share (an embedding's gradient sums in another
    order on other thread counts), with ``groups`` MoE dispatch groups (a
    context of that many data shards)."""
    import contextlib

    from repro_torch.dist import sharding as SH
    from repro_torch.launch.dryrun import MeshShape
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS

    cfg = _smoke_f32(arch)
    opt = _opt(lr, steps)
    params = M.init_params(cfg, seed=0, device="cpu")
    state = TS.TrainState(params, opt.init(params))
    pipe = _pipe(cfg, seq, batch, 0, 1)
    step = TS.make_train_step(cfg, opt, microbatches)
    metrics = []
    with (SH.axis_rules(MeshShape((groups, 1), ("data", "model")))
          if groups > 1 else contextlib.nullcontext()):
        for s in range(steps):
            b = {k: torch.from_numpy(v) for k, v in pipe.batch(s).items()}
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "whole": _numpy_state(state)}


def _grad_on_another_thread():
    """Make every ``torch.autograd.grad`` run on a thread of its own, as
    the CUDA autograd engine runs a backward on its device thread: what
    the caller's thread holds in a thread-local is not there."""
    import threading

    grad = torch.autograd.grad

    def call(*args, **kwargs):
        box = {}

        def run():
            try:
                box["out"] = grad(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box["err"] = e

        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=120)
        if "err" in box:
            raise box["err"]
        return box["out"]

    torch.autograd.grad = call


def dp_train_rank(rank, world, arch, steps, lr, seq, batch, microbatches,
                  ckpt_save, ckpt_load, remat=None, grad_thread=False,
                  one_unit=False):
    """``steps`` data-parallel steps of ``arch``'s smoke width in float32
    from seed 0: metrics, the whole state gathered at the end (rank 0),
    each rank's dims and blocks, the parameter bytes it stores (model
    storage and blocks) and each step's peak of gathered bytes.
    ``ckpt_load``: restore that checkpoint first (its state is step 0's
    start); ``ckpt_save``: rank 0 writes the whole state there after the
    last step.  ``remat`` replaces the config's; ``grad_thread`` runs each
    backward on another thread; ``one_unit`` gathers the whole model as
    one unit around each forward (the units inside find nothing left to
    gather)."""
    from repro_torch.dist import sharding as SH
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import train_step as TS

    cfg = _smoke_f32(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if grad_thread:
        _grad_on_another_thread()
    if one_unit:
        forward = M.forward
        M.forward = lambda cfg, params, batch: SH.gathered(
            [params], lambda: forward(cfg, params, batch))()
    opt = _opt(lr, steps)
    mesh = _cpu_mesh((world, 1), ("data", "model"))
    with SH.axis_rules(mesh, *SH.select_rules(cfg)):
        dp = TS.DataParallel(cfg, opt, mesh, microbatches)
        state = dp.init(M.init_params(cfg, seed=0, device="cpu"))
        stored = [dp.param_bytes(state)]
        if ckpt_load:
            dp.load(state, CK.restore(ckpt_load, CK.latest_step(ckpt_load),
                                      dp.host_state()))
        pipe = _pipe(cfg, seq, batch, rank, world)
        metrics, gathered = [], []
        for s in range(steps):
            b = {k: torch.from_numpy(v) for k, v in pipe.batch(s).items()}
            state, m = dp.step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
            gathered.append(dp.gathered_peak_bytes)
            stored.append(dp.param_bytes(state))
        whole = dp.full_state(state)
        if ckpt_save and rank == 0:
            CK.save(ckpt_save, steps, whole, async_=False)
        blocks = {"m": [t.numpy().copy() for t in state.opt.m],
                  "shards": [t.detach().numpy().copy() for t in state.shards]}
        return {"metrics": metrics, "dims": dp.dims, "blocks": blocks,
                "stored": stored, "gathered": gathered,
                "moment_bytes": sum(t.untyped_storage().nbytes()
                                    for t in state.opt.m + state.opt.v),
                "whole": _numpy_state(whole) if rank == 0 else None}


def contiguous_rank(rank, world, arch):
    """One data-parallel step (and a whole-state gather) with every
    collective checked for contiguous tensors, as NCCL requires (gloo
    takes any): the collectives' names and count, the number of units,
    of sharded parameters and of whole ones."""
    import torch.distributed as dist

    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS

    calls = []

    def checked(fn):
        def call(*args, **kwargs):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            assert all(t.is_contiguous() for t in tensors), fn.__name__
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return call

    for name in ("all_reduce", "all_gather_into_tensor",
                 "reduce_scatter_tensor"):
        setattr(dist, name, checked(getattr(dist, name)))
    cfg = _smoke_f32(arch)
    dp = TS.DataParallel(cfg, _opt(1e-3, 2), _cpu_mesh((world, 1),
                                                       ("data", "model")))
    params = M.init_params(cfg, seed=0, device="cpu")
    units = len(params.pro) + len(params.blocks) // params.unit_len
    state = dp.init(params)
    b = {k: torch.from_numpy(v)
         for k, v in _pipe(cfg, 16, 8, rank, world).batch(0).items()}
    state, _ = dp.step(state, b)
    dp.full_state(state)
    sharded = sum(d is not None for d in dp.dims)
    return (sorted(set(calls)), len(calls), units, sharded,
            len(dp.dims) - sharded)
