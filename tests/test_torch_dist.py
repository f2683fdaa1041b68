"""The port's distributed layer (`repro_torch.dist`, `launch/mesh.py`, the
spec surface, `launch/dryrun.py`) against the reference's `repro.dist`.

The reference runs in-process on one CPU device: its `resolve_spec` and
`dispatch_groups` read only mesh shapes.  Collectives run on gloo ranks
spawned by `torch_dist_ranks.run_ranks`.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.dist import compression as RC
from repro.dist import pipeline_parallel as RPP
from repro.dist import sharding as RSH
from repro.models import model as RM
from repro.train import optimizer as ROPT
from repro_torch import configs, convert
from repro_torch.dist import compression as C
from repro_torch.dist import pipeline_parallel as PP
from repro_torch.dist import sharding as SH
from repro_torch.launch import mesh as MESH
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.train.optimizer import opt_state_specs

from torch_dist_ranks import (compressed_rank, constraint_rank, pipeline_rank,
                              run_ranks)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(configs.ARCHS)


class _FakeMesh:
    def __init__(self, **shape):
        self.shape = shape


MESHES = {"1x1": dict(data=1, model=1), "2x2": dict(data=2, model=2),
          "8x16": dict(data=8, model=16), "16x16": dict(data=16, model=16),
          "pod2x16x16": dict(pod=2, data=16, model=16)}
TABLES = {"act": "ACT_RULES", "param": "PARAM_RULES",
          "fsdp_act": "FSDP_ACT_RULES"}


# ---------------------------------------------------------------------------
# rule tables and resolution
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("table", sorted(TABLES.values()))
def test_rule_tables_equal_the_reference(table):
    assert getattr(SH, table) == getattr(RSH, table)


def _leaves(tree, is_leaf):
    if is_leaf(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v, is_leaf)
    else:
        for v in tree:
            yield from _leaves(v, is_leaf)


@pytest.fixture(scope="module")
def spec_leaves():
    """(shape, names) of every leaf of every config's parameter, cache
    and input spec trees at full width, in the reference's layout, and of
    every port parameter (a block's own, unstacked)."""
    out = []
    for arch in ARCHS:
        cfg = configs.get(arch)
        specs = M.param_specs(cfg)
        out += [(tuple(p.shape), specs[n]) for n, p in
                M.init_params(cfg, device="meta").named_parameters()]
        rcfg = rconfigs.get(arch)
        shapes = jax.eval_shape(lambda c=rcfg: RM.init_params(
            c, jax.random.PRNGKey(0)))
        trees = [(shapes, RM.param_specs(rcfg)),
                 (RM.cache_shapes(rcfg, 128, 32768), RM.cache_specs(rcfg))]
        for kind in ("train", "prefill", "decode"):
            trees.append((RM.input_specs(rcfg, 4096, 256, kind),
                          RM.input_spec_names(rcfg, kind)))
        for s, n in trees:
            jax.tree.map(lambda a, b: out.append((tuple(a.shape), tuple(b))),
                         s, n, is_leaf=lambda x: isinstance(x, tuple) and all(
                             isinstance(e, (str, type(None))) for e in x))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("table", sorted(TABLES))
def test_resolve_spec_equals_the_reference_on_every_spec_leaf(
        spec_leaves, mesh, table):
    m = _FakeMesh(**MESHES[mesh])
    rules = getattr(SH, TABLES[table])
    rrules = getattr(RSH, TABLES[table])
    names = {n for _, ns in spec_leaves for n in ns} | set(rules)
    assert len(spec_leaves) > 5000
    for shape, ns in spec_leaves:
        assert SH.resolve_spec(shape, ns, m, rules) == tuple(
            RSH.resolve_spec(shape, ns, m, rrules)), (shape, ns)
    # every logical name alone, on dims that every group divides and not
    for n in names:
        for dim in (1, 24, 256, 4096, 6144):
            got = SH.resolve_spec((dim,), (n,), m, rules)
            assert got == tuple(RSH.resolve_spec((dim,), (n,), m, rrules))


def test_resolve_spec_elastic_mesh_reuses_tables():
    mesh = _FakeMesh(data=8, model=16)
    assert SH.resolve_spec((256, 4096, 2048), ("batch", "seq", "embed"),
                           mesh, SH.ACT_RULES) == ("data", None, None)
    assert SH.resolve_spec((6144, 16384), ("embed", "mlp"), mesh,
                           SH.PARAM_RULES) == (None, ("model", "data"))


def test_resolve_spec_unknown_names_replicate():
    mesh = _FakeMesh(data=16, model=16)
    assert SH.resolve_spec((4, 32, 7), ("layers", None, "nonsense"), mesh,
                           SH.PARAM_RULES) == (None, None, None)


def test_resolve_spec_divisibility_fallback_and_axis_reuse():
    assert SH.resolve_spec((24, 128), ("heads", "head_dim"),
                           _FakeMesh(data=1, model=1),
                           SH.ACT_RULES) == (None, None)
    mesh = _FakeMesh(data=16, model=16)
    # 24 heads do not split 16 ways: the shards move onto head_dim
    assert SH.resolve_spec((2048, 24, 128), ("embed", "heads", "head_dim"),
                           mesh, SH.PARAM_RULES) == (None, None, "data")
    assert SH.resolve_spec((2048, 32, 256), ("embed", "heads", "head_dim"),
                           mesh, SH.PARAM_RULES) == (None, "model", "data")
    assert SH.resolve_spec((256, 4096, 2048), ("batch", "seq", "embed"),
                           mesh, SH.ACT_RULES) == ("data", None, None)


def test_logical_constraint_no_context_is_identity():
    x = torch.ones(4, 8)
    assert SH.logical_constraint(x, ("batch", "seq")) is x


def test_dispatch_groups_follows_context():
    assert SH.dispatch_groups(1024) == 1
    mesh = _FakeMesh(data=16, model=16)
    with SH.axis_rules(mesh):
        assert SH.dispatch_groups(1024) == 16
    with SH.axis_rules(mesh, act_rules=SH.FSDP_ACT_RULES):
        assert SH.dispatch_groups(1024) == 256
    assert SH.dispatch_groups(1024) == 1
    assert SH.dispatch_groups(mesh=_FakeMesh(pod=2, data=16, model=16)) == 32


def test_axis_rules_nesting_restores_previous():
    m1, m2 = _FakeMesh(data=4), _FakeMesh(data=2, model=2)
    with SH.axis_rules(m1):
        with SH.axis_rules(m2, act_rules=SH.FSDP_ACT_RULES):
            assert SH.dispatch_groups() == 4
            with SH.axis_rules(None):
                assert SH.dispatch_groups() == 1
            assert SH.dispatch_groups() == 4
        assert SH.dispatch_groups() == 4
        assert SH._CTX.act_rules is SH.ACT_RULES
    assert SH.dispatch_groups() == 1 and SH._CTX.mesh is None


def test_axis_rules_is_thread_local():
    import threading

    seen = []
    with SH.axis_rules(_FakeMesh(data=8)):
        t = threading.Thread(target=lambda: seen.append(SH.dispatch_groups()))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert SH.dispatch_groups() == 8
    assert seen == [1]


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_recomputes_under_its_forward_context(remat):
    """A block that `remat` recomputes in a backward on another thread
    (autograd's device thread, on the card), after the context has
    closed, sees the context its forward ran under."""
    import threading

    from repro_torch.models import transformer as T

    seen = []

    def block(x):
        seen.append(SH.dispatch_groups())
        return torch.sin(x @ x)

    x = torch.ones(3, 3, requires_grad=True)
    with SH.axis_rules(_FakeMesh(data=4, model=2)):
        y = T.remat(remat, block)(x).sum()
    t = threading.Thread(target=lambda: torch.autograd.grad(y, x))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert seen == [4, 4] and SH.dispatch_groups() == 1


@pytest.mark.parametrize("mode", ["fsdp", "tp", "auto"])
def test_select_rules_modes(mode):
    class Cfg:
        parallelism = mode

    act, param = SH.select_rules(Cfg())
    ract, rparam = RSH.select_rules(Cfg())
    assert act == ract and param == rparam
    assert (act is SH.FSDP_ACT_RULES) == (mode == "fsdp")
    assert param is SH.PARAM_RULES


class _DevMesh:
    """The attributes of a DeviceMesh that placements read."""
    mesh_dim_names = ("pod", "data", "model")
    shape = (2, 4, 2)


def test_to_placements_shards_each_mesh_dim_on_its_tensor_dim():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _DevMesh()
    assert SH._mesh_shape(mesh) == {"pod": 2, "data": 4, "model": 2}
    assert SH.to_placements((None, ("model", "data"), "pod"), mesh) == (
        Shard(2), Shard(1), Shard(1))
    assert SH.to_placements((None, None), mesh) == (Replicate(),) * 3
    assert SH.act_sharding((8, 4), ("batch", None), mesh) == (
        Shard(0), Shard(0), Replicate())
    tree = SH.shard_tree({"w": torch.empty(6, 8, device="meta"),
                          "b": [torch.empty(8, device="meta")]},
                         {"w": ("embed", "mlp"), "b": [("mlp",)]}, mesh)
    # ("model", "data") divides 8: both dims shard it
    assert tree == {"w": (Replicate(), Shard(1), Shard(1)),
                    "b": [(Replicate(), Shard(0), Shard(0))]}


def test_logical_constraint_redistributes_a_dtensor(tmp_path):
    res = run_ranks(constraint_rank, 2, str(tmp_path / "store"))
    for shape, placements, equal, local_same, groups in res:
        assert shape == (8, 6) and equal and local_same and groups == 2
        assert placements == ["S(0)", "R"]


def test_mesh_module_touches_nothing_on_import_and_needs_a_group():
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch.distributed as d, repro_torch.launch.mesh as m; "
         "print(d.is_initialized(), m.PEAK_FLOPS_BF16, m.HBM_BW, "
         "m.NVLINK_BW, m.production_shape(True))"],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "False"
    assert "989000000000000.0 3350000000000.0 450000000000.0" in out.stdout
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="process group"):
            MESH.make_production_mesh()


# ---------------------------------------------------------------------------
# the spec trees
# ---------------------------------------------------------------------------
def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_equal_the_reference(arch):
    cfg, rcfg = configs.get(arch), rconfigs.get(arch)
    model = M.init_params(cfg, device="meta")
    specs, rspecs = M.param_specs(cfg), RM.param_specs(rcfg)
    assert list(specs) == [n for n, _ in model.named_parameters()]
    used = set()
    for name, p in model.named_parameters():
        path, layer = convert.reference_path(model, name)
        ref = _at(rspecs, path)
        if layer is not None:
            assert ref[0] == "layers"
            ref = ref[1:]
        assert specs[name] == ref, name
        assert len(ref) == p.dim(), name
        used.add(tuple(path))
    is_names = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(e, (str, type(None))) for e in x)
    n_ref = len(list(_leaves(rspecs, is_names)))
    assert len(used) == n_ref
    opt, ropt = opt_state_specs(specs), ROPT.opt_state_specs(rspecs)
    assert opt.step == ropt.step == ()
    assert opt.m == opt.v == list(specs.values())
    assert ropt.m == ropt.v == rspecs


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_specs_equal_the_reference(arch):
    cfg, rcfg = configs.get(arch), rconfigs.get(arch)
    assert M.cache_specs(cfg) == RM.cache_specs(rcfg)
    for kind in ("train", "prefill", "decode"):
        assert M.input_spec_names(cfg, kind) == RM.input_spec_names(rcfg,
                                                                    kind)
        got = M.input_specs(cfg, 4096, 256, kind)
        ref = RM.input_specs(rcfg, 4096, 256, kind)
        assert sorted(got) == sorted(ref)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(ref[k].shape)
            assert str(t.dtype).split(".")[1] == str(ref[k].dtype)
    with pytest.raises(ValueError):
        M.input_specs(cfg, 8, 2, "serve")


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
def _x32(seed, n=4096, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(
        np.float32)


@pytest.mark.parametrize("x", [
    _x32(0), _x32(1, 1000, 1e-3), np.zeros(64, np.float32),
    np.full(17, 1e30, np.float32), np.array([-1e30, 1e30, 0.0], np.float32),
    np.array([1e-30], np.float32),
    np.linspace(-1.0, 1.0, 255).astype(np.float32),
    (np.arange(-127, 128) / 127.0 * 3.5).astype(np.float32),  # ties
], ids=["normal", "small", "zeros", "huge", "mixed-extreme", "tiny",
        "linspace", "halves"])
def test_quantize_equals_the_reference_bit_for_bit(x):
    c, res = C.quantize(torch.from_numpy(x))
    rc, rres = RC.quantize(jnp.asarray(x))
    assert c.q.dtype == torch.int8 and c.scale.dtype == torch.float32
    np.testing.assert_array_equal(c.q.numpy(), np.asarray(rc.q))
    assert c.scale.numpy().tobytes() == np.asarray(rc.scale).tobytes()
    assert res.numpy().tobytes() == np.asarray(rres).tobytes()
    assert C.dequantize(c).numpy().tobytes() == np.asarray(
        RC.dequantize(rc)).tobytes()


def test_quantize_bf16_and_carried_error_equal_the_reference():
    x = _x32(3, 2048)
    err = _x32(4, 2048, 1e-2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    rxb = jnp.asarray(x, jnp.bfloat16)
    c, res = C.quantize(xb)
    rc, rres = RC.quantize(rxb)
    assert res.dtype == torch.bfloat16
    np.testing.assert_array_equal(c.q.numpy(), np.asarray(rc.q))
    assert float(c.scale) == float(rc.scale)
    np.testing.assert_array_equal(res.float().numpy(),
                                  np.asarray(rres, np.float32))
    c, res = C.quantize(torch.from_numpy(x), torch.from_numpy(err))
    rc, rres = RC.quantize(jnp.asarray(x), jnp.asarray(err))
    np.testing.assert_array_equal(c.q.numpy(), np.asarray(rc.q))
    assert res.numpy().tobytes() == np.asarray(rres).tobytes()


def test_error_feedback_tracks_the_true_sum():
    rng = np.random.default_rng(5)
    err, total, true, scales = None, 0.0, 0.0, []
    for _ in range(200):
        g = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
        c, err = C.quantize(g, err)
        total = total + C.dequantize(c).double()
        true = true + g.double()
        scales.append(float(c.scale))
    # the carried residual is all that separates the sums: O(scale), not
    # O(steps x scale)
    gap = float((total - true).abs().max())
    assert gap <= max(scales) / 2 * 1.001
    assert gap < 0.05 * sum(scales)


def test_compressed_all_reduce_on_gloo_ranks(tmp_path):
    xs = np.stack([_x32(10 + r, 1000) for r in range(2)])
    errs = np.stack([_x32(20 + r, 1000, 1e-3) for r in range(2)])
    for err in (None, errs):
        res = run_ranks(compressed_rank, 2, str(tmp_path / f"s{err is None}"),
                        xs, err)
        plain = sum(C.dequantize(C.quantize(
            torch.from_numpy(xs[r]),
            None if err is None else torch.from_numpy(err[r]))[0]).numpy()
            for r in range(2))
        for r, (total, residual) in enumerate(res):
            np.testing.assert_array_equal(total, plain)
            _, want = C.quantize(torch.from_numpy(xs[r]), None if err is None
                                 else torch.from_numpy(err[r]))
            np.testing.assert_array_equal(residual, want.numpy())


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------
def test_bubble_fraction():
    assert PP.bubble_fraction(1, 8) == 0.0
    assert abs(PP.bubble_fraction(4, 4) - 3 / 7) < 1e-9
    assert PP.bubble_fraction(4, 28) < 0.1
    for p, m in ((2, 6), (4, 6), (8, 3)):
        assert PP.bubble_fraction(p, m) == RPP.bubble_fraction(p, m)


def _pp_data():
    rng = np.random.default_rng(0)
    ws = rng.normal(0, 0.1, (8, 16, 16)).astype(np.float32)
    x = rng.normal(0, 1, (6, 8, 16)).astype(np.float32)
    return ws, x


def test_sequential_apply_equals_the_reference():
    ws, x = _pp_data()
    got = PP.sequential_apply(lambda a, w: torch.tanh(a @ w),
                              torch.from_numpy(ws), torch.from_numpy(x))
    ref = RPP.sequential_apply(lambda a, w: jnp.tanh(a @ w), jnp.asarray(ws),
                               jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("world,mesh", [(2, (2, 1)), (2, (1, 2)),
                                        (4, (4, 1)), (4, (2, 2)),
                                        (4, (1, 4))],
                         ids=["2r-P1", "2r-P2", "4r-P1", "4r-P2", "4r-P4"])
def test_pipeline_apply_equals_sequential_bit_for_bit(tmp_path, world, mesh):
    ws, x = _pp_data()
    want = PP.sequential_apply(lambda a, w: torch.tanh(a @ w),
                               torch.from_numpy(ws), torch.from_numpy(x))
    outs = run_ranks(pipeline_rank, world, str(tmp_path / "store"), mesh,
                     ws, x)
    for got in outs:
        assert got.tobytes() == want.numpy().tobytes()


# ---------------------------------------------------------------------------
# MoE dispatch groups
# ---------------------------------------------------------------------------
def test_n_groups_reads_the_context():
    assert MOE._n_groups(64) == 1
    with SH.axis_rules(_FakeMesh(data=4, model=1)):
        assert MOE._n_groups(64) == 4
        assert MOE._n_groups(6) == 2      # halved until it divides
        assert MOE._n_groups(7) == 1
    with SH.axis_rules(_FakeMesh(data=4, model=2), SH.FSDP_ACT_RULES):
        assert MOE._n_groups(64) == 8


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x22b"])
def test_grouped_moe_forward_equals_the_reference(arch, monkeypatch):
    rcfg = dataclasses.replace(rconfigs.get_smoke(arch), dtype="float32")
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    model = convert.decoder_from_reference(
        cfg, jax.tree.map(lambda a: np.asarray(a, np.float32), rp), "cpu")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 16)).astype(np.int32)
    with torch.inference_mode():
        one, _ = M.forward(cfg, model, {"tokens": torch.from_numpy(toks)})
        with SH.axis_rules(_FakeMesh(data=4, model=1)):
            logits, aux = M.forward(cfg, model,
                                    {"tokens": torch.from_numpy(toks)})
    monkeypatch.setattr(RSH, "dispatch_groups", lambda t=None, **kw: 4)
    rlogits, raux = RM.forward(rcfg, rp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5, atol=1e-7)
    # four groups of 16 tokens drop other pairs than one group of 64
    assert not torch.allclose(one, logits, atol=1e-4)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_grouped_sorted_dispatch_plan_is_per_group(groups):
    cfg = configs.get_smoke("deepseek-moe-16b")
    top_i = torch.from_numpy(np.random.default_rng(groups).integers(
        0, cfg.n_experts, (64, cfg.top_k)))
    plan = MOE.sorted_dispatch_plan(cfg, top_i, groups)
    tl = 64 // groups
    assert plan["cap"] == MOE.capacity(cfg, tl)
    for g in range(groups):
        one = MOE.sorted_dispatch_plan(cfg, top_i[g * tl:(g + 1) * tl])
        for k, v in one.items():
            if k != "cap":
                assert torch.equal(plan[k][g], v[0]), k


# ---------------------------------------------------------------------------
# isolation and the dry run
# ---------------------------------------------------------------------------
NEW_MODULES = ["repro_torch.dist", "repro_torch.dist.sharding",
               "repro_torch.dist.compression",
               "repro_torch.dist.pipeline_parallel",
               "repro_torch.launch.mesh", "repro_torch.launch.dryrun"]


def test_isolation_walk_covers_the_new_modules():
    code = ("import json, pkgutil, importlib, sys, repro_torch; "
            "names = [m.name for m in pkgutil.walk_packages("
            "repro_torch.__path__, 'repro_torch.')]; "
            "[importlib.import_module(n) for n in names]; "
            "print(json.dumps({'names': names, 'bad': sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))}))")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(ROOT, "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout)
    assert set(NEW_MODULES) <= set(res["names"]) and res["bad"] == []


def _ref_state_bytes(arch, mesh):
    """Per-device bytes of the reference's parameters and of its AdamW
    state (an int32 step, two float32 moments), by its own resolution."""
    rcfg = rconfigs.get(arch)
    shapes = jax.eval_shape(lambda: RM.init_params(rcfg,
                                                   jax.random.PRNGKey(0)))
    sizes = dict(mesh.shape)
    params, moments = [], []

    def one(s, n):
        spec = RSH.resolve_spec(s.shape, n, mesh, RSH.PARAM_RULES)
        shards = 1
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                shards *= sizes[a]
        params.append(s.size * s.dtype.itemsize // shards)
        moments.append(s.size * 4 // shards)

    jax.tree.map(one, shapes, RM.param_specs(rcfg),
                 is_leaf=lambda x: isinstance(x, tuple) and all(
                     isinstance(e, (str, type(None))) for e in x))
    return sum(params), 4 + 2 * sum(moments)


def test_dryrun_all_cells_on_both_meshes_and_param_bytes_equal_reference(
        tmp_path):
    out_json = tmp_path / "dryrun.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--out", str(out_json)],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    rows = json.loads(out_json.read_text())
    want = {(a, s, mp) for a in configs.ARCHS for s in configs.SHAPES
            for mp in (False, True)}
    assert {(r["arch"], r["shape"], r["multi_pod"]) for r in rows} == want
    for r in rows:
        skipped = (r["arch"], r["shape"]) in configs.SKIPS
        assert r["status"] == ("skip" if skipped else "ok"), r
    ok = [r for r in rows if r["status"] == "ok"]
    assert len(ok) == 2 * (len(configs.ARCHS) * len(configs.SHAPES)
                           - len(configs.SKIPS))
    ref_bytes = {}
    for r in ok:
        mp = r["multi_pod"]
        mesh = _FakeMesh(**(MESHES["pod2x16x16"] if mp else MESHES["16x16"]))
        key = (r["arch"], mp)
        if key not in ref_bytes:
            ref_bytes[key] = _ref_state_bytes(r["arch"], mesh)
        assert r["param_bytes"] == ref_bytes[key][0], key
        if r["kind"] == "train":
            assert r["opt_bytes"] == ref_bytes[key][1], key
        assert r["argument_bytes"] >= r["param_bytes"]
        assert r["flops"] > 0 and r["flops_by"] == "flop_counter"
        assert r["flops_per_device_ideal"] == r["flops"] / (
            512 if mp else 256)
        assert r["fits_80gb"] == (r["argument_bytes"] <= 80e9)
        cfg = configs.get(r["arch"])
        assert (r["params"], r["active_params"]) == (
            cfg.param_count(), cfg.active_param_count())


def test_dryrun_flops_count_is_linear_in_units():
    """The two-unit extrapolation equals counting the whole stack."""
    from repro_torch.launch import dryrun

    cfg = dataclasses.replace(configs.get_smoke("jamba-1.5-large-398b"),
                              n_layers=12, hybrid_period=4)
    for kind in ("train", "prefill", "decode"):
        got = dryrun.step_flops(cfg, 64, 2, kind)
        whole = dryrun._counted_flops(dataclasses.replace(cfg, remat="none"),
                                      64, 2, kind)
        assert got == whole
