"""Dry run: size every (arch x shape x production mesh) cell with no
device and no process group.

The reference (`repro.launch.dryrun`) lowers and compiles each cell with
XLA on 512 placeholder devices.  The port's analogue builds the model on
the ``meta`` device (shapes and types, no storage) and, for each cell:

  * resolves every parameter, optimizer-state, decode-cache and input
    spec with the port's rules (`repro_torch.dist.sharding`) against the
    (16, 16) and the (2, 16, 16) mesh's axis sizes;
  * sums the per-device argument bytes (each tensor's bytes over the
    product of the mesh axes its spec shards it on) and says whether they
    fit one H100's 80 GB;
  * counts the step's FLOPs with `torch.utils.flop_counter.FlopCounterMode`
    over a meta forward (plus the backward for train, with remat "none":
    no recomputation counted), and divides them evenly over the mesh's
    devices (``flops_per_device_ideal``, an ideal split, not a
    partitioned program's count).

A decoder's FLOPs are linear in its scanned units, so they are counted at
one and at two units (the prologue included) and extrapolated to the
config's depth; the encdec family is counted whole.  Every family's
forward runs on ``meta`` (``flops_by`` says "flop_counter"); a cell whose
forward fails there is a ``fail`` row.

The port's data-parallel step stores what these specs place: on the
train driver's ``(n, 1)`` mesh a rank of `train_step.DataParallel` holds
exactly ``device_bytes`` of the parameters (its block of each one the
rules shard, the others whole) and twice that of their float32 analogue
in moments (FSDP storage, as the reference's driver places its
parameters).  A step adds the float32 gradient blocks, one unit's
gathered weights at a time and the activations, which the dry run does
not count.

What it does not give: the reference's collective bytes (parsed from
XLA's HLO by ``benchmarks/hlo_cost.py``) and its temporaries; the port
has no partitioner to ask.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out dryrun.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import torch

from repro_torch.configs import ARCHS, SHAPES, SKIPS, get, get_smoke
from repro_torch.dist import sharding as SH
from repro_torch.launch.mesh import production_shape
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import opt_state_specs

#: one H100's device memory
DEVICE_BYTES = 80e9


class MeshShape:
    """A mesh's axis sizes, with no device behind them: all that
    resolution reads."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))


def production_mesh_shape(multi_pod: bool) -> MeshShape:
    return MeshShape(*production_shape(multi_pod))


def device_bytes(shapes, names, mesh, rules) -> int:
    """Bytes one device holds of a tree of meta tensors placed by its
    logical ``names`` under ``rules``."""
    sizes = SH._mesh_shape(mesh)
    total = []

    def one(t, n):
        spec = SH.resolve_spec(tuple(t.shape), n, mesh, rules)
        shards = math.prod(sizes[a] for e in spec for a in SH.spec_axes(e))
        total.append(t.numel() * t.element_size() // shards)

    SH.map_specs(one, shapes, names)
    return sum(total)


def _param_shapes(params):
    return {n: p for n, p in params.named_parameters()}


def _meta_inputs(cfg, seq_len, batch, kind):
    return {k: torch.zeros(v.shape, dtype=v.dtype, device="meta")
            for k, v in M.input_specs(cfg, seq_len, batch, kind).items()}


def _counted_flops(cfg: ModelConfig, seq_len: int, batch: int,
                   kind: str) -> int:
    """FlopCounterMode's total over one meta step of ``cfg``."""
    from torch.utils.flop_counter import FlopCounterMode

    params = M.init_params(cfg, device="meta")
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            M.loss_fn(cfg, params, _meta_inputs(cfg, seq_len, batch,
                                                kind)).backward()
        elif kind == "prefill":
            with torch.no_grad():
                M.forward(cfg, params, _meta_inputs(cfg, seq_len, batch,
                                                    kind))
        else:
            cache = M.cache_shapes(cfg, batch, seq_len)
            M.decode_step(cfg, params, cache,
                          _meta_inputs(cfg, seq_len, batch, kind)["tokens"])
    return int(fc.get_total_flops())


def _with_units(cfg: ModelConfig, units: int) -> ModelConfig:
    pro, unit, _ = T.stack_plan(cfg)
    return dataclasses.replace(cfg, n_layers=len(pro) + units * len(unit))


def step_flops(cfg: ModelConfig, seq_len: int, batch: int, kind: str) -> int:
    """FlopCounterMode's count of one step of ``kind``."""
    cfg = dataclasses.replace(cfg, remat="none")
    if cfg.family == "encdec":
        return _counted_flops(cfg, seq_len, batch, kind)
    n_scan = T.stack_plan(cfg)[2]
    one = _counted_flops(_with_units(cfg, 1), seq_len, batch, kind)
    if n_scan == 1:
        return one
    two = _counted_flops(_with_units(cfg, 2), seq_len, batch, kind)
    return one + (n_scan - 1) * (two - one)


def cell_sizes(cfg: ModelConfig, shape_name: str, mesh) -> dict:
    """Per-device bytes of every argument of the cell's step on
    ``mesh``."""
    seq_len, global_batch, kind = SHAPES[shape_name]
    act_rules, param_rules = SH.select_rules(cfg)
    params = _param_shapes(M.init_params(cfg, device="meta"))
    pspecs = M.param_specs(cfg)
    out = {"param_bytes": device_bytes(params, pspecs, mesh, param_rules)}
    if kind == "train":
        p32 = {n: torch.empty(p.shape, dtype=torch.float32, device="meta")
               for n, p in params.items()}
        opt = opt_state_specs(pspecs)
        step = torch.empty((), dtype=torch.int32, device="meta")
        out["opt_bytes"] = device_bytes(
            (step, list(p32.values()), list(p32.values())),
            (opt.step, opt.m, opt.v), mesh, param_rules)
    if kind == "decode":
        out["cache_bytes"] = device_bytes(
            M.cache_shapes(cfg, global_batch, seq_len), M.cache_specs(cfg),
            mesh, act_rules)
    out["input_bytes"] = device_bytes(
        M.input_specs(cfg, seq_len, global_batch, kind),
        M.input_spec_names(cfg, kind), mesh, act_rules)
    out["argument_bytes"] = sum(out.values())
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             cfg_override=None, flops=None) -> dict:
    """One cell's row; ``flops`` (`step_flops`) is counted when not
    given."""
    cfg = cfg_override or get(arch)
    seq_len, global_batch, kind = SHAPES[shape_name]
    mesh = production_mesh_shape(multi_pod)
    n_dev = math.prod(mesh.shape.values())
    t0 = time.time()
    sizes = cell_sizes(cfg, shape_name, mesh)
    if flops is None:
        flops = step_flops(cfg, seq_len, global_batch, kind)
    return {
        "arch": arch, "shape": shape_name, "kind": kind,
        "mesh": list(mesh.shape.values()), "axes": list(mesh.shape),
        "multi_pod": multi_pod,
        **sizes,
        "fits_80gb": sizes["argument_bytes"] <= DEVICE_BYTES,
        "flops": flops, "flops_by": "flop_counter",
        "flops_per_device_ideal": flops / n_dev,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "tokens": seq_len * global_batch if kind != "decode"
        else global_batch,
        "seconds": time.time() - t0,
        "status": "ok",
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="size the reduced smoke configs instead of the "
                         "published ones")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch in ARCHS and args.shape in SHAPES:
        cells = [(args.arch, args.shape)]
    else:
        ap.error(f"--all, or --arch of {sorted(ARCHS)} and --shape of "
                 f"{sorted(SHAPES)}")

    results = []
    for arch, shape in cells:
        if (arch, shape) in SKIPS:
            for multi_pod in (False, True):
                results.append({"arch": arch, "shape": shape,
                                "multi_pod": multi_pod, "status": "skip",
                                "reason": SKIPS[(arch, shape)]})
            print(f"SKIP {arch} x {shape}: {SKIPS[(arch, shape)]}",
                  flush=True)
            continue
        cfg = get_smoke(arch) if args.smoke else get(arch)
        seq_len, batch, kind = SHAPES[shape]
        flops = None
        for multi_pod in (False, True):
            try:
                if flops is None:
                    flops = step_flops(cfg, seq_len, batch, kind)
                r = run_cell(arch, shape, multi_pod, cfg, flops)
                print(f"OK   {arch} x {shape} on {r['mesh']}: "
                      f"{r['argument_bytes'] / 2**30:.2f} GiB/dev "
                      f"({'fits' if r['fits_80gb'] else 'over'} 80 GB), "
                      f"{r['flops_per_device_ideal']:.3e} FLOP/dev "
                      f"({r['flops_by']})", flush=True)
            except Exception as e:  # noqa: BLE001 — report, keep sweeping
                r = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                     "status": "fail", "error": f"{type(e).__name__}: {e}"}
                print(f"FAIL {arch} x {shape}: {r['error']}", flush=True)
            results.append(r)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    n_fail = sum(r["status"] == "fail" for r in results)
    if n_fail:
        raise SystemExit(f"{n_fail}/{len(results)} cells failed")


if __name__ == "__main__":
    main()
