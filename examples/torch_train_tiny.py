"""Train a reduced granite-family model end to end in the PyTorch port on
the packed synthetic pipeline: data -> train_step -> checkpoint ->
restore -> resume.

    PYTHONPATH=src python examples/torch_train_tiny.py [--steps 60] [--device cpu]

The port's counterpart of `examples/train_tiny.py`.  Without
``--device`` it trains on the CUDA card; ``--device cpu`` asks for the
CPU.  The restored state is drawn from another seed first, so the resumed
step's loss shows that the checkpoint, not the seed, carried the run.
"""
import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.kernels.common import resolve_device
from repro_torch.models import model as M
from repro_torch.train import checkpoint as CK
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import AdamW, cosine_schedule

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--steps", type=int, default=60)
ap.add_argument("--d-model", type=int, default=128)
ap.add_argument("--layers", type=int, default=4)
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()
dev = resolve_device(args.device)

cfg = dataclasses.replace(get_smoke("granite-3-2b"),
                          d_model=args.d_model, n_layers=args.layers)
pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=64,
                                    global_batch=8, seed=0), device=dev)
opt = AdamW(lr=cosine_schedule(3e-3, warmup=10, total=args.steps))


def batch_at(step):
    return {k: torch.from_numpy(v).to(dev)
            for k, v in pipe.batch(step).items()}


def fresh_state(seed):
    params = M.init_params(cfg, seed=seed, device=dev)
    return TS.TrainState(params, opt.init(params))


state = fresh_state(0)
step_fn = TS.make_train_step(cfg, opt)
with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as ckpt_dir:
    t0 = time.time()
    for step in range(args.steps):
        state, metrics = step_fn(state, batch_at(step))
        if step % 10 == 0:
            print(f"step {step:4d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}")
        if step == args.steps // 2:
            CK.save(ckpt_dir, step, state, async_=False)
            print(f"  checkpointed at step {step} -> {ckpt_dir}")
    print(f"final loss {float(metrics['loss']):.4f} "
          f"({args.steps} steps in {time.time()-t0:.1f}s on {dev})")

    # restart from the checkpoint into a state drawn from another seed
    latest = CK.latest_step(ckpt_dir)
    restored = CK.restore(ckpt_dir, latest, fresh_state(1))
    restored, metrics = step_fn(restored, batch_at(latest + 1))
    print(f"restored at step {latest}, resumed: loss "
          f"{float(metrics['loss']):.4f} (restart path verified)")
