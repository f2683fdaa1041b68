"""Data-parallel training (`train_step.DataParallel`, the train driver on
a mesh) on gloo ranks, held against the one-device step.

Tolerances are `chip_smoke.py`'s `train_check`'s: loss and grad norm to
1e-5 relative; each parameter within twice the learning rate of each
step taken (AdamW divides by sqrt(v) + 1e-8, so an element whose gradient
is at rounding-noise level takes a normalized step anywhere in [-1, 1]).
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.dist import sharding as SH
from repro_torch.launch.dryrun import MeshShape, device_bytes
from repro_torch.models import model as M
from repro_torch.train import checkpoint as CK
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import AdamW, cosine_schedule

from torch_dist_ranks import (contiguous_rank, dp_train_rank, one_device_rank,
                              run_ranks)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, STEPS, LR, SEQ, BATCH = "granite-3-2b", 3, 3e-3, 32, 8
RTOL = 1e-5


def _one_rank(steps=STEPS, microbatches=1):
    """The one-device run the ranks are held against: metrics and the
    final state."""
    cfg = dataclasses.replace(get_smoke(ARCH), dtype="float32")
    opt = AdamW(lr=cosine_schedule(LR, warmup=10, total=steps))
    params = M.init_params(cfg, seed=0, device="cpu")
    state = TS.TrainState(params, opt.init(params))
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=SEQ,
                                        global_batch=BATCH, seed=0),
                         device="cpu")
    step = TS.make_train_step(cfg, opt, microbatches)
    metrics = []
    for s in range(steps):
        b = {k: torch.from_numpy(v) for k, v in pipe.batch(s).items()}
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


def _state_np(state):
    return {"params": {n: p.detach().numpy()
                       for n, p in state.params.named_parameters()},
            "m": [t.numpy() for t in state.opt.m],
            "v": [t.numpy() for t in state.opt.v],
            "step": int(state.opt.step)}


def _ranks(world, tmp_path, tag, steps=STEPS, microbatches=1, save=None,
           load=None, arch=ARCH, remat=None, grad_thread=False,
           one_unit=False):
    return run_ranks(dp_train_rank, world, str(tmp_path / f"store_{tag}"),
                     arch, steps, LR, SEQ, BATCH, microbatches, save, load,
                     remat, grad_thread, one_unit)


def _one_device(tmp_path, microbatches=1, arch=ARCH, groups=1):
    """`_one_rank` in a process of the ranks' thread count, with
    ``groups`` MoE dispatch groups."""
    (res,) = run_ranks(one_device_rank, 1, str(tmp_path / "store_ref"), arch,
                       STEPS, LR, SEQ, BATCH, microbatches, groups)
    return res["metrics"], res["whole"]


@pytest.mark.parametrize("microbatches", [1, 2])
def test_one_rank_data_parallel_is_the_one_device_step_bit_for_bit(
        tmp_path, microbatches):
    (got,) = _ranks(1, tmp_path, "one", microbatches=microbatches)
    want, ref = _one_device(tmp_path, microbatches)
    assert got["metrics"] == want
    assert all(d is None for d in got["dims"])
    for n, a in got["whole"]["params"].items():
        assert a.tobytes() == ref["params"][n].tobytes(), n
    for k in ("m", "v"):
        for a, b in zip(got["whole"][k], ref[k]):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", [ARCH, "deepseek-moe-16b"])
def test_two_ranks_equal_one_rank_at_the_same_global_batch(tmp_path, arch):
    """An MoE model's ranks equal one device dispatching in as many
    groups (each rank's tokens are one group), router loss included."""
    res = _ranks(2, tmp_path, "two", arch=arch)
    want, ref = _one_device(tmp_path, arch=arch, groups=2)
    dims = res[0]["dims"]
    assert res[1]["dims"] == dims and sum(d is not None for d in dims) > 10
    lrs = [m["lr"] for m in want]
    for r in res:
        for g, w in zip(r["metrics"], want):
            assert abs(g["loss"] - w["loss"]) <= RTOL * abs(w["loss"])
            assert abs(g["grad_norm"] - w["grad_norm"]) <= RTOL * abs(
                w["grad_norm"])
            assert g["lr"] == w["lr"]
    whole = res[0]["whole"]
    assert whole["step"] == ref["step"] == STEPS
    bound = 2 * sum(lrs)
    for n, a in whole["params"].items():
        assert np.abs(a - ref["params"][n]).max() <= bound, n
    # each rank holds its block of every sharded tensor, the whole of the
    # others
    for rank, r in enumerate(res):
        for i, d in enumerate(dims):
            name = list(whole["params"])[i]
            full_p, full_m = whole["params"][name], whole["m"][i]
            if d is None:
                assert r["blocks"]["shards"][i].tobytes() == full_p.tobytes()
                continue
            n = full_p.shape[d] // 2
            sl = [slice(None)] * full_p.ndim
            sl[d] = slice(rank * n, (rank + 1) * n)
            np.testing.assert_array_equal(r["blocks"]["shards"][i],
                                          full_p[tuple(sl)])
            np.testing.assert_array_equal(r["blocks"]["m"][i],
                                          full_m[tuple(sl)])


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_moe_ranks_recompute_their_router_under_the_forward_context(
        tmp_path, remat):
    """2 deepseek-moe ranks with each backward on another thread (as on
    the card): a block that remat recomputes there averages the router's
    dispatch fractions over the ranks as its forward did, so the first
    moments (linear in the gradients) and the metrics equal remat
    "none"'s."""
    kw = dict(arch="deepseek-moe-16b", steps=2, grad_thread=True)
    want = _ranks(2, tmp_path, "none", remat="none", **kw)
    got = _ranks(2, tmp_path, remat, remat=remat, **kw)
    for g, w in zip(got, want):
        for gm, wm in zip(g["metrics"], w["metrics"]):
            for k in ("loss", "grad_norm"):
                assert abs(gm[k] - wm[k]) <= RTOL * abs(wm[k]), k
        for i, (a, b) in enumerate(zip(g["blocks"]["m"], w["blocks"]["m"])):
            np.testing.assert_allclose(a, b, rtol=RTOL,
                                       atol=RTOL * np.abs(b).max(),
                                       err_msg=str(i))


def test_grouping_by_unit_changes_no_value_against_one_group(tmp_path):
    """Each unit gathered and reduce-scattered alone gives the values of
    the whole model gathered as one unit (one all-gather before the
    forward, one reduce-scatter after the backward), bit for bit."""
    units = _ranks(2, tmp_path, "units")
    one = _ranks(2, tmp_path, "group", one_unit=True)
    for a, b in zip(units, one):
        assert a["metrics"] == b["metrics"]
        for k in ("m", "shards"):
            for x, y in zip(a["blocks"][k], b["blocks"][k]):
                assert x.tobytes() == y.tobytes()
        # one unit holds every sharded weight at once
        assert b["gathered"][0] > 2 * a["gathered"][0]
    for k in ("m", "v"):
        for x, y in zip(units[0]["whole"][k], one[0]["whole"][k]):
            assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("world", [1, 2])
def test_every_collective_gets_contiguous_tensors(tmp_path, world):
    """NCCL refuses a non-contiguous tensor (a tied embedding's gradient
    is transposed); gloo takes it, so the CPU checks the inputs.  A step
    gathers each unit for its forward and again for its backward and
    reduce-scatters it once, then all-reduces each whole parameter's
    gradient (plus the label count, the norm and the loss); a whole-state
    gather gathers each sharded parameter and both its moments alone."""
    for names, n, units, sharded, whole in run_ranks(
            contiguous_rank, world, str(tmp_path / "store"), ARCH):
        assert names == (["all_gather_into_tensor", "all_reduce",
                          "reduce_scatter_tensor"] if world > 1
                         else ["all_reduce"])
        assert (sharded > 0) == (world > 1) and units == 4
        assert n == ((3 * units if world > 1 else 0) + whole + 3
                     + 3 * sharded)


def test_checkpoints_cross_rank_counts_bit_for_bit(tmp_path):
    # written by 2 ranks, restored into one
    two = tmp_path / "two"
    res = _ranks(2, tmp_path, "save", save=str(two))
    written = res[0]["whole"]
    cfg = dataclasses.replace(get_smoke(ARCH), dtype="float32")
    opt = AdamW(lr=cosine_schedule(LR, warmup=10, total=STEPS))
    params = M.init_params(cfg, seed=1, device="cpu")
    state = CK.restore(str(two), CK.latest_step(str(two)),
                       TS.TrainState(params, opt.init(params)))
    got = _state_np(state)
    assert got["step"] == written["step"] == STEPS
    for n, a in got["params"].items():
        assert a.tobytes() == written["params"][n].tobytes(), n
    for k in ("m", "v"):
        for a, b in zip(got[k], written[k]):
            assert a.tobytes() == b.tobytes()
    # written by one, restored into 2 ranks (no step taken)
    one = tmp_path / "one"
    _, state = _one_rank()
    CK.save(str(one), STEPS, state, async_=False)
    ref = _state_np(state)
    res = _ranks(2, tmp_path, "load", steps=0, load=str(one))
    whole = res[0]["whole"]
    assert whole["step"] == STEPS
    for n, a in whole["params"].items():
        assert a.tobytes() == ref["params"][n].tobytes(), n
    for k in ("m", "v"):
        for a, b in zip(whole[k], ref[k]):
            assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------
def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **extra)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        if k not in extra:
            env.pop(k, None)
    return env


def _driver(*args, env=None):
    return [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
            "--device", "cpu", *args], env or _env()


def _run_ranks_cli(world, url, *args, timeout=300):
    procs = []
    try:
        for r in range(world):
            cmd, env = _driver(*args, "--dist-init", url, "--rank", str(r),
                               "--world-size", str(world))
            procs.append(subprocess.Popen(cmd, env=env, cwd=ROOT, text=True,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE))
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def test_driver_trains_on_two_gloo_ranks_and_resumes_on_one(tmp_path):
    ck = tmp_path / "ck"
    mj = tmp_path / "m.json"
    res = _run_ranks_cli(2, f"file://{tmp_path / 'store'}", "--steps", "3",
                         "--ckpt-dir", str(ck), "--ckpt-every", "2",
                         "--metrics-out", str(mj))
    for rc, out, err in res:
        assert rc == 0, err[-3000:]
    out0 = res[0][1].splitlines()
    cfg = get_smoke(ARCH)
    stored = device_bytes(
        dict(M.init_params(cfg, device="meta").named_parameters()),
        M.param_specs(cfg), MeshShape((2, 1), ("data", "model")),
        SH.PARAM_RULES)
    assert out0[0] == ("data parallel: 2 rank(s) over gloo, mesh (2, 1) "
                       "('data', 'model'), 28 of 38 parameters sharded, "
                       f"{stored:,} parameter bytes a rank")
    assert out0[-1].startswith("done: final loss")
    assert res[1][1] == ""                     # rank 1 prints nothing
    rec = json.loads(mj.read_text())
    assert rec["world"] == 2 and len(rec["loss"]) == 3
    assert rec["peak_mem_gb"] == [None, None]
    assert rec["loss_by_rank"] == [rec["loss"]] * 2
    assert CK.latest_step(str(ck)) == 2
    cmd, env = _driver("--steps", "5", "--ckpt-dir", str(ck), "--resume")
    one = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    assert one.stdout.splitlines()[0] == "resumed from step 2"


def test_driver_at_one_rank_repeats_the_plain_path(tmp_path):
    plain, dp = tmp_path / "plain.json", tmp_path / "dp.json"
    cmd, env = _driver("--steps", "3", "--metrics-out", str(plain))
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ((rc, _, err),) = _run_ranks_cli(1, f"file://{tmp_path / 'store'}",
                                     "--steps", "3", "--metrics-out", str(dp))
    assert rc == 0, err[-3000:]
    a, b = json.loads(plain.read_text()), json.loads(dp.read_text())
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]


def test_driver_joins_from_the_torchrun_environment(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd, env = _driver("--steps", "1", env=_env(
        RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
        MASTER_PORT=str(port)))
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("data parallel: 1 rank(s) over gloo")


@pytest.mark.parametrize("args,msg", [
    (("--rank", "0"), "need --dist-init"),
    (("--dist-init", "file:///nowhere"), "needs --rank"),
    (("--dist-init", "file:///nowhere", "--rank", "2", "--world-size", "2"),
     "outside a world"),
    (("--dist-init", "file:///nowhere", "--rank", "0", "--world-size", "3"),
     "does not split"),
])
def test_driver_refuses_bad_rank_flags(args, msg):
    cmd, env = _driver(*args)
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2 and msg in out.stderr
