"""Train driver: the reference's `repro.launch.train` on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --steps 50 --ckpt-dir /tmp/ckpt

trains the architecture at its full width on the CUDA card; ``--smoke``
takes its reduced config and ``--device cpu`` asks for the CPU.  The
loop is the reference's: weights from seed 0, the deterministic token
pipeline (`repro_torch.data.pipeline`), AdamW on a cosine schedule
(warm-up 10), async atomic checkpoints every ``--ckpt-every`` steps,
``--resume`` from the newest one, and the heartbeat ledger.  One process
and one card: no mesh until the port's ``dist/``.  It prints ``step N
loss ... gnorm ... s/step`` every 10 steps, ``resumed from step N`` and
``done: final loss ...``.

The token pipeline yields no ``frames``, so the encdec family
(whisper-tiny) is refused with exit code 2 (the reference's driver dies
on a ``KeyError`` there).
"""
from __future__ import annotations

import argparse
import time

import torch


def build_state(cfg, opt, device):
    """Params from seed 0 and a zeroed optimizer state on ``device``."""
    from repro_torch.models import model as M
    from repro_torch.train.train_step import TrainState

    params = M.init_params(cfg, seed=0, device=device)
    return TrainState(params, opt.init(params))


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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA "
                         "card)")
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
    dev = resolve_device(args.device)

    opt = AdamW(lr=cosine_schedule(args.lr, warmup=10, total=args.steps))
    pipe = TokenPipeline(PipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.global_batch,
        seed=0), device=dev)
    ledger = FT.HeartbeatLedger(1)

    state = build_state(cfg, opt, dev)
    start = 0
    if args.resume and args.ckpt_dir:
        latest = CK.latest_step(args.ckpt_dir)
        if latest is not None:
            state = CK.restore(args.ckpt_dir, latest, state)
            start = latest + 1
            print(f"resumed from step {latest}")
    step_fn = TS.make_train_step(cfg, opt, args.microbatches)
    ckpt_thread = metrics = None
    for step in range(start, args.steps):
        t0 = time.time()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch(step).items()}
        state, metrics = step_fn(state, batch)
        ledger.beat(0, step)
        stragglers, dead = ledger.classify(step)
        if dead:
            plan = FT.plan_recovery(
                ledger, step, (1,), ("data",), hosts_per_pod=1,
                ckpt_latest=CK.latest_step(args.ckpt_dir)
                if args.ckpt_dir else None)
            print(f"!! dead hosts {dead}: recovery plan {plan}")
        if step % 10 == 0:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{time.time()-t0:.2f}s/step", flush=True)
        if args.ckpt_dir and step and step % args.ckpt_every == 0:
            if ckpt_thread is not None:
                ckpt_thread.join()  # one in flight
            ckpt_thread = CK.save(args.ckpt_dir, step, state,
                                  extra={"arch": cfg.name})
    if ckpt_thread is not None:
        ckpt_thread.join()
    if metrics is not None:
        print(f"done: final loss {float(metrics['loss']):.4f}")


if __name__ == "__main__":
    main()
