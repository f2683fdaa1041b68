"""FSDP storage in the data-parallel step (`train_step.DataParallel`) on
gloo ranks: what a rank stores against the dry run's per-device bytes,
how much of the model is gathered at once during a step, and the values
against the one-device step.

Every run takes its backward on another thread, as the CUDA autograd
engine runs it on its device thread.  Tolerances are
`test_torch_dist_train.py`'s (`chip_smoke.py`'s `train_check`): loss and
grad norm to 1e-5 relative, each parameter within twice the learning
rate of each step taken.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.dist import sharding as SH
from repro_torch.launch.dryrun import MeshShape, device_bytes
from repro_torch.models import model as M
from repro_torch.train import checkpoint as CK

from torch_dist_ranks import dp_train_rank, one_device_rank, run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["granite-3-2b", "deepseek-moe-16b", "mamba2-2.7b"]
STEPS, LR, SEQ, BATCH = 2, 3e-3, 32, 8
RTOL = 1e-5

_RUNS = {}


def _ranks(factory, arch, world, remat="none", microbatches=1):
    """`dp_train_rank` on ``world`` gloo ranks (each backward on another
    thread), once a module for each argument set."""
    key = ("dp", arch, world, remat, microbatches)
    if key not in _RUNS:
        store = factory.mktemp("store") / "s"
        _RUNS[key] = run_ranks(dp_train_rank, world, str(store), arch,
                               STEPS, LR, SEQ, BATCH, microbatches, None,
                               None, remat, True)
    return _RUNS[key]


def _one_device(factory, arch, groups):
    """The one-device step with ``groups`` MoE dispatch groups: metrics
    and the final state."""
    key = ("one", arch, groups)
    if key not in _RUNS:
        store = factory.mktemp("store") / "s"
        (res,) = run_ranks(one_device_rank, 1, str(store), arch, STEPS, LR,
                           SEQ, BATCH, 1, groups)
        _RUNS[key] = res
    return _RUNS[key]


def _cfg(arch):
    import dataclasses
    return dataclasses.replace(get_smoke(arch), dtype="float32")


def _mesh(world):
    return MeshShape((world, 1), ("data", "model"))


def _per_device(cfg, world, dtype=None):
    """The dry run's per-device bytes of the parameters (in ``dtype``,
    default theirs) at an (n, 1) mesh."""
    model = M.init_params(cfg, device="meta")
    shapes = {n: p if dtype is None else p.to(dtype)
              for n, p in model.named_parameters()}
    return device_bytes(shapes, M.param_specs(cfg), _mesh(world),
                        SH.PARAM_RULES)


def _unit_bytes(cfg, world):
    """Each unit's sharded parameters' bytes at full shape: the embedding
    with the final norm, each prologue block, each scanned unit."""
    model = M.init_params(cfg, device="meta")
    specs = M.param_specs(cfg)
    name = {id(p): n for n, p in model.named_parameters()}

    def sharded(p):
        spec = SH.resolve_spec(tuple(p.shape), specs[name[id(p)]],
                               _mesh(world), SH.PARAM_RULES)
        return any(e is not None for e in spec)

    u = model.unit_len
    units = ([[model.embed, model.final_norm]] + [[b] for b in model.pro]
             + [list(model.blocks[i:i + u])
                for i in range(0, len(model.blocks), u)])
    return [sum(p.numel() * p.element_size() for m in unit
                for p in m.parameters() if sharded(p)) for unit in units]


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_a_rank_stores_the_dry_runs_per_device_bytes(tmp_path_factory, arch,
                                                     world):
    """Outside a step (after init and after each step) a rank's
    parameter storage, the model's and its blocks', is the dry run's
    per-device parameter bytes at an (n, 1) mesh, and its moments twice
    the float32 analogue."""
    cfg = _cfg(arch)
    want = _per_device(cfg, world)
    moments = 2 * _per_device(cfg, world, torch.float32)
    for r in _ranks(tmp_path_factory, arch, world):
        assert r["stored"] == [want] * (STEPS + 1)
        assert r["moment_bytes"] == moments
    if world > 1:
        assert want < _per_device(cfg, 1)


@pytest.mark.parametrize("arch,remat", [
    ("granite-3-2b", "none"), ("granite-3-2b", "dots"),
    ("granite-3-2b", "full"), ("deepseek-moe-16b", "none"),
    ("deepseek-moe-16b", "dots")])
def test_a_step_gathers_at_most_two_units_at_once(tmp_path_factory, arch,
                                                  remat):
    """At 4 ranks, the gathered weights alive at any moment of a step
    (forward, the backward's gathers again or recomputation) are at most
    the two largest units' bytes, and at least the largest: a step that
    kept what the forward gathered for the backward would hold the whole
    model."""
    units = sorted(_unit_bytes(_cfg(arch), 4))
    for r in _ranks(tmp_path_factory, arch, 4, remat):
        for peak in r["gathered"]:
            assert units[-1] <= peak <= units[-1] + units[-2], (peak, units)
        assert sum(units) > units[-1] + units[-2]


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_is_the_one_device_step_bit_for_bit(tmp_path_factory,
                                                      arch):
    (got,) = _ranks(tmp_path_factory, arch, 1)
    ref = _one_device(tmp_path_factory, arch, 1)
    assert got["metrics"] == ref["metrics"]
    assert all(d is None for d in got["dims"])
    for n, a in got["whole"]["params"].items():
        assert a.tobytes() == ref["whole"]["params"][n].tobytes(), n
    for k in ("m", "v"):
        for a, b in zip(got["whole"][k], ref["whole"][k]):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch,world,remat,microbatches", [
    ("granite-3-2b", 2, "none", 1), ("granite-3-2b", 2, "dots", 1),
    ("granite-3-2b", 2, "full", 1), ("granite-3-2b", 4, "none", 1),
    ("granite-3-2b", 4, "dots", 1), ("granite-3-2b", 4, "full", 1),
    ("granite-3-2b", 2, "none", 2), ("deepseek-moe-16b", 2, "none", 1),
    ("deepseek-moe-16b", 4, "none", 1), ("deepseek-moe-16b", 4, "dots", 1),
    ("mamba2-2.7b", 2, "none", 1), ("mamba2-2.7b", 4, "none", 1)])
def test_ranks_agree_with_one_device(tmp_path_factory, arch, world, remat,
                                     microbatches):
    """n ranks against one device (an MoE model's with n dispatch groups,
    one a rank): every rank's metrics, and the whole state rank 0
    gathers.  With two microbatches a rank gathers and reduce-scatters
    each unit once a microbatch and sums the float32 blocks; no label is
    masked, so against the one-device step on the whole batch the split
    changes only rounding."""
    res = _ranks(tmp_path_factory, arch, world, remat, microbatches)
    groups = world if get_smoke(arch).n_experts else 1
    ref = _one_device(tmp_path_factory, arch, groups)
    assert sum(d is not None for d in res[0]["dims"]) > 10
    for r in res:
        for g, w in zip(r["metrics"], ref["metrics"]):
            for k in ("loss", "grad_norm"):
                assert abs(g[k] - w[k]) <= RTOL * abs(w[k]), (k, g, w)
            assert g["lr"] == w["lr"]
    whole = res[0]["whole"]
    assert whole["step"] == ref["whole"]["step"] == STEPS
    bound = 2 * sum(m["lr"] for m in ref["metrics"])
    for n, a in whole["params"].items():
        assert np.abs(a - ref["whole"]["params"][n]).max() <= bound, n


def test_driver_resumes_on_two_ranks_from_one(tmp_path):
    """A checkpoint written by one process restores into two gloo ranks
    through the driver's host state, and training goes on."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        env.pop(k, None)
    ck = tmp_path / "ck"
    base = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
            "--device", "cpu", "--ckpt-dir", str(ck), "--ckpt-every", "2"]
    one = subprocess.run(base + ["--steps", "3"], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    assert CK.latest_step(str(ck)) == 2
    url = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen(
        base + ["--steps", "5", "--resume", "--dist-init", url, "--rank",
                str(r), "--world-size", "2"], env=env, cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    lines = outs[0][0].splitlines()
    assert lines[1] == "resumed from step 2"
    assert lines[-1].startswith("done: final loss")
    assert CK.latest_step(str(ck)) == 4
