"""The paper's technique inside the LM, in the PyTorch port: MoE token
dispatch IS sorted-array lower-bound search.

Shows: (1) router -> sorted expert ids, (2) segment boundaries via
lower_bound (the paper's operation: ``torch.searchsorted`` in the
dispatch), (3) a learned LINEAR model of the boundary positions is
near-exact because the router's aux loss flattens the id CDF, and its
verified error window is searched by the bounded last-mile kernel (B1,
on int32 keys) to the same boundaries.

    PYTHONPATH=src python examples/torch_moe_dispatch_demo.py [--device cpu]

The port's counterpart of `examples/moe_dispatch_demo.py`.  Without
``--device`` it runs on the CUDA card, where the window search launches
B1; ``--device cpu`` runs its plain version.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels.bounded_search.ops import lower_bound_windows
from repro_torch.models import model as M
from repro_torch.models import moe

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()

cfg = dataclasses.replace(get_smoke("deepseek-moe-16b"), n_experts=16,
                          top_k=2, dtype="float32")
params = M.init_params(cfg, seed=0, device=args.device)
layer = params.blocks[0].moe
torch.set_grad_enabled(False)         # a serving demo: no autograd graph
dev = layer["router"].device
x = torch.randn((512, cfg.d_model), generator=torch.Generator(
    device=dev).manual_seed(1), device=dev)

top_p, top_i, aux = moe._router(cfg, layer, x)
plan = moe.sorted_dispatch_plan(cfg, top_i)
flat = plan["e_sorted"][0]
e = cfg.n_experts
seg = plan["seg_start"][0]                 # lower_bound(flat, e), exact

# learned index over the same array: linear CDF model + verified error
slope = flat.numel() / e
pred = torch.arange(e, device=dev) * slope
err = int(np.ceil(float((pred - seg).abs().max())))
lo = torch.clamp(pred.to(torch.int32) - err, min=0)
found = lower_bound_windows(flat.to(torch.int32),
                            torch.arange(e, dtype=torch.int32, device=dev),
                            lo, 2 * err + 2)
print(f"{'expert':>6s} {'true_start':>10s} {'linear_pred':>11s} "
      f"{'window_search':>13s}")
for i in range(0, e, 4):
    print(f"{i:>6d} {int(seg[i]):>10d} {float(pred[i]):>11.1f} "
          f"{int(found[i]):>13d}")
assert torch.equal(found.long(), seg)
print(f"\nmax |pred - true| = {err} slots over {flat.numel()} assignments "
      f"(bound width {2 * err + 1} vs log2 search "
      f"{int(np.log2(flat.numel()))} probes); the window search equals "
      f"lower_bound on every expert")

out, aux = moe.moe_ffn(cfg, layer, x[None])
print(f"moe_ffn output {tuple(out.shape)}, aux loss {float(aux):.4f}, "
      f"capacity {plan['cap']} a expert, {int(plan['keep'].sum())} of "
      f"{plan['keep'].numel()} pairs kept — the sorted dispatch runs this "
      "machinery inside every MoE layer (models/moe.py)")
