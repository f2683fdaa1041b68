"""End-to-end token serving in the PyTorch port: batched requests through a
smoke-size LM with the paged KV cache and the learned-index slot lookup.

    PYTHONPATH=src python examples/torch_serve_paged_kv.py [--device cpu]

The port's counterpart of `examples/serve_paged_kv.py`.  Without
``--device`` it runs on the CUDA card, where the slot lookup launches the
bounded-search kernel on int32 keys; ``--device cpu`` runs its plain
version.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.models import model as M
from repro_torch.serve.engine import ServeEngine

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()

cfg = get_smoke("granite-3-2b")
params = M.init_params(cfg, seed=0, device=args.device)
engine = ServeEngine(cfg, params, max_batch=4, max_seq=96, page_size=8,
                     device=args.device)

rng = np.random.default_rng(0)
rids = [engine.submit(list(rng.integers(2, cfg.vocab, rng.integers(3, 9))),
                      max_new=6) for _ in range(6)]
print(f"submitted {len(rids)} requests (continuous batching, "
      f"{engine.max_batch} slots) on {engine.device}")

outs = engine.run(max_steps=64)
for rid in rids:
    print(f"request {rid}: generated {outs[rid]}")

print(f"\nKV pool utilization after drain: {engine.kv.alloc.utilization:.2f}")

# the learned-index slot lookup on a live batch layout
engine2 = ServeEngine(cfg, params, max_batch=4, max_seq=96, page_size=8,
                      device=args.device)
for r in rids[:3]:
    engine2.submit([2, 3, 4, 5], max_new=8)
engine2.step()
idx = engine2.kv.slot_index()
slots = torch.arange(9, dtype=torch.int32, device=engine2.device)
print("flat slot -> request id (learned linear index + verified fixup):",
      idx.lookup(slots).cpu().numpy())
