"""Train driver: the reference's `repro.launch.train`, on one device or
data-parallel over `torch.distributed`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --steps 50 --ckpt-dir /tmp/ckpt

trains the architecture at its full width on the CUDA card; ``--smoke``
takes its reduced config and ``--device cpu`` asks for the CPU.  The
loop is the reference's: weights from ``--seed`` (0, the reference's
fixed seed), the deterministic token pipeline
(`repro_torch.data.pipeline`), AdamW on a cosine schedule
(warm-up 10), async atomic checkpoints every ``--ckpt-every`` steps,
``--resume`` from the newest one, and the heartbeat ledger.  It prints
``step N loss ... gnorm ... s/step`` every 10 steps, ``resumed from step
N`` and ``done: final loss ...``.

Data parallel: with ``--dist-init URL --rank R --world-size N`` (an
explicit ``tcp://host:port`` or ``file:///path``), or under torchrun
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), each process
is one rank of a process group, NCCL on the CUDA cards (rank R on card
``LOCAL_RANK``, else R modulo the card count) and gloo on the CPU.  The
ranks form an ``(N, 1)`` ("data", "model") mesh (`launch/mesh.py`); each
stores, for every parameter, the block of it and of both moments that
the config's parameter rules place on it (`repro_torch.dist.sharding`;
FSDP storage, as the reference's driver places its parameters), takes
its host slice of the global batch and runs `train_step.DataParallel`'s
step, which gathers one unit of the model at a time.  Rank 0 prints
(the first line: the ranks, the mesh, the sharded parameters and the
parameter bytes a rank stores) and writes the checkpoints, in the
one-device format (full tensors, gathered to its host), so a run of N
ranks resumes from a run of any other count.  Without those flags the
driver runs one process on one device, as before.  ``--metrics-out
FILE`` writes every step's loss, grad norm and seconds (each step ends
in a synchronize), each rank's peak device memory and each rank's
losses as JSON.

The token pipeline yields no ``frames``, so the encdec family
(whisper-tiny) is refused with exit code 2 (the reference's driver dies
on a ``KeyError`` there).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch


def build_state(cfg, opt, device, seed=0):
    """Params from ``seed`` and a zeroed optimizer state on ``device``."""
    from repro_torch.models import model as M
    from repro_torch.train.train_step import TrainState

    params = M.init_params(cfg, seed=seed, device=device)
    return TrainState(params, opt.init(params))


def dist_args(args, ap):
    """``(url, rank, world)`` from the flags or torchrun's environment;
    None for one process."""
    env = os.environ
    url, rank, world = args.dist_init, args.rank, args.world_size
    if url is None and {"RANK", "WORLD_SIZE", "MASTER_ADDR",
                        "MASTER_PORT"} <= set(env):
        url = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    if url is None:
        if rank is not None or world is not None:
            ap.error("--rank and --world-size need --dist-init")
        return None
    if rank is None or world is None:
        ap.error("--dist-init needs --rank and --world-size")
    if not 0 <= rank < world:
        ap.error(f"--rank {rank} outside a world of {world}")
    return url, rank, world


def init_distributed(url: str, rank: int, world: int, device):
    """Join the process group: NCCL on a CUDA device (``None`` or an
    unindexed ``cuda``: this rank's card, ``LOCAL_RANK`` or the rank
    modulo the cards), gloo on the CPU.  Returns the rank's device."""
    import torch.distributed as dist

    from repro_torch.kernels.common import resolve_device

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            resolve_device(None)            # raises without a card
            local = os.environ.get("LOCAL_RANK")
            dev = torch.device("cuda", int(local) if local is not None
                               else rank % torch.cuda.device_count())
        dev = resolve_device(dev)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=url, rank=rank,
                                world_size=world, device_id=dev)
    else:
        dist.init_process_group("gloo", init_method=url, rank=rank,
                                world_size=world)
    return dev


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial weights")
    ap.add_argument("--remat", choices=("none", "dots", "full"),
                    help="recompute policy (default: the config's)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA "
                         "card)")
    ap.add_argument("--dist-init", default=None,
                    help="process group address, tcp://host:port or "
                         "file:///path (data-parallel training)")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--metrics-out", default=None,
                    help="write per-step metrics and peak memory as JSON")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCHS, get, get_smoke
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.kernels.common import resolve_device
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import fault_tolerance as FT
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import AdamW, cosine_schedule

    if args.arch not in ARCHS:
        ap.error(f"unknown --arch {args.arch!r}; known: {sorted(ARCHS)}")
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    if cfg.family == "encdec":
        ap.error(f"--arch {args.arch}: the token pipeline yields no "
                 "'frames', which the encdec family trains on")
    if args.remat is not None:
        cfg = dataclasses.replace(cfg, remat=args.remat)
    dist_spec = dist_args(args, ap)
    rank, world = 0, 1
    if dist_spec is None:
        dev = resolve_device(args.device)
    else:
        # the rank's card is chosen before any device is resolved
        url, rank, world = dist_spec
        if args.global_batch % (world * args.microbatches):
            ap.error(f"--global-batch {args.global_batch} does not split "
                     f"into {world} ranks x {args.microbatches} microbatches")
        dev = init_distributed(url, rank, world, args.device)
    say = print if rank == 0 else (lambda *a, **k: None)

    opt = AdamW(lr=cosine_schedule(args.lr, warmup=10, total=args.steps))
    pipe = TokenPipeline(PipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.global_batch,
        seed=0, host_id=rank, n_hosts=world), device=dev)
    ledger = FT.HeartbeatLedger(world)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    dp = mesh = None
    if dist_spec is None:
        state = build_state(cfg, opt, dev, args.seed)
        step_fn = TS.make_train_step(cfg, opt, args.microbatches)
    else:
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import model as M

        mesh = make_mesh((world, 1), ("data", "model"))
        # the config's parameter rules (`sharding.select_rules`)
        dp = TS.DataParallel(cfg, opt, mesh, args.microbatches)
        # the whole model once, then only this rank's blocks and moments
        state = dp.init(M.init_params(cfg, seed=args.seed, device=dev))
        say(f"data parallel: {world} rank(s) over "
            f"{torch.distributed.get_backend()}, mesh ({world}, 1) "
            f"('data', 'model'), {sum(d is not None for d in dp.dims)} of "
            f"{len(dp.dims)} parameters sharded, "
            f"{dp.param_bytes(state):,} parameter bytes a rank", flush=True)
        step_fn = dp.step
    start = 0
    if args.resume and args.ckpt_dir:
        latest = CK.latest_step(args.ckpt_dir)
        if latest is not None:
            if dp is None:
                state = CK.restore(args.ckpt_dir, latest, state)
            else:   # the whole state on the host, then this rank's blocks
                dp.load(state, CK.restore(args.ckpt_dir, latest,
                                          dp.host_state()))
            start = latest + 1
            say(f"resumed from step {latest}")
    ckpt_thread = metrics = None
    record = {"loss": [], "grad_norm": [], "step_s": []}
    for step in range(start, args.steps):
        t0 = time.time()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch(step).items()}
        state, metrics = step_fn(state, batch)
        if args.metrics_out:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            record["step_s"].append(time.time() - t0)
            record["loss"].append(float(metrics["loss"]))
            record["grad_norm"].append(float(metrics["grad_norm"]))
        # a data-parallel step's collectives complete only once every
        # rank has reached it: each rank saw every rank's beat
        for host in range(world):
            ledger.beat(host, step)
        stragglers, dead = ledger.classify(step)
        if dead:
            plan = FT.plan_recovery(
                ledger, step, (world, 1) if mesh else (1,),
                ("data", "model") if mesh else ("data",), hosts_per_pod=1,
                ckpt_latest=CK.latest_step(args.ckpt_dir)
                if args.ckpt_dir else None)
            say(f"!! dead hosts {dead}: recovery plan {plan}")
        if step % 10 == 0:
            say(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"{time.time()-t0:.2f}s/step", flush=True)
        if args.ckpt_dir and step and step % args.ckpt_every == 0:
            whole = state if dp is None else dp.full_state(state)
            if rank == 0:
                if ckpt_thread is not None:
                    ckpt_thread.join()  # one in flight
                ckpt_thread = CK.save(args.ckpt_dir, step, whole,
                                      extra={"arch": cfg.name})
            del whole
    if ckpt_thread is not None:
        ckpt_thread.join()
    if args.metrics_out:
        peak = [torch.cuda.max_memory_allocated(dev) / 1e9
                if dev.type == "cuda" else None]
        losses = [record["loss"]]
        if dp is not None:
            peaks, losses = [None] * world, [None] * world
            torch.distributed.all_gather_object(peaks, peak[0])
            torch.distributed.all_gather_object(losses, record["loss"])
            peak = peaks
        if rank == 0:
            with open(args.metrics_out, "w") as f:
                json.dump(dict(record, arch=cfg.name, world=world,
                               device=str(dev), remat=cfg.remat,
                               peak_mem_gb=peak, loss_by_rank=losses), f)
    if metrics is not None:
        say(f"done: final loss {float(metrics['loss']):.4f}")
    if dist_spec is not None:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
