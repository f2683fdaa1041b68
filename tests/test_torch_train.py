"""The port's training path (`repro_torch.train`, `repro_torch.launch.train`
and the gradients of `repro_torch.models`) against the reference's
(`repro.train`, `repro.launch.train`, ``jax.value_and_grad``).

Weights and optimizer state are the reference's, carried across by
`convert`; inputs are numpy from a seed or the token pipeline's batches.
Tolerances, all in float32 (bf16 is held where stated):

- optimizer: params, ``m`` and ``v`` within 1e-6 relative (plus 1e-12
  absolute) after five steps; bf16 params equal or one ulp apart; the
  schedule within 1e-6 relative (XLA's and torch's float32 ``cos``
  differ in the last bit on a few percent of arguments, which ``1 +
  cos`` can double).
- a gradient: ``|port - ref| <= 1e-5 + 1e-4 * |ref|`` (measured 2e-7 to
  2e-6 at a largest gradient of ~0.5), the loss within 1e-5 relative.
- a train step: loss, grad norm and lr within 1e-5 relative; params
  within 1e-5 absolute on at least 99.9% of the elements, and every
  element within twice the learning rates summed over the steps.  AdamW
  divides by ``sqrt(v) + 1e-8``, so an element whose gradient is at the
  frameworks' noise level (|g| ~ 1e-9, far inside the gradient
  tolerance) takes a normalized step anywhere in [-1, 1] on either side
  (measured: 3.3e-4 at a learning rate of 1.5e-3 on 3 of 16,384 elements
  of one tensor after the first step; 1e-5 exceeded on 0.01-0.03% of
  each tensor).  The moments within 1e-5 relative and 1e-7 absolute.
- resuming from a checkpoint, and every remat mode: bit for bit.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data import pipeline as rpipe
from repro.models import model as RM
from repro.models import moe as RMOE
from repro.train import fault_tolerance as RFT
from repro.train import optimizer as RO
from repro.train import train_step as RTS
from repro_torch import configs, convert
from repro_torch.data import pipeline
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.train import checkpoint as CK
from repro_torch.train import fault_tolerance as FT
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS

STEP_RTOL, PARAM_ATOL, PARAM_SHARE = 1e-5, 1e-5, 1e-3


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _pair(arch, dtype="float32", **kw):
    """(reference cfg, port cfg, reference params, port model)."""
    rcfg = dataclasses.replace(rconfigs.get_smoke(arch), dtype=dtype, **kw)
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=dtype, **kw)
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, cfg, rp, convert.model_from_reference(cfg, _np(rp), "cpu")


def _dropless(arch):
    """Capacity for every (token, choice) pair, so that a tie cannot flip
    which pairs are dropped."""
    c = rconfigs.get_smoke(arch)
    return dict(capacity_factor=1.001 * c.n_experts / c.top_k) \
        if c.n_experts else {}


def _batch(cfg, seed=3, b=2, s=16):
    """The same batch for both: (reference's, port's)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(-1, cfg.vocab, (b, s)).astype(np.int32)
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    pb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    if cfg.family == "encdec":
        f = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
        rb["frames"] = jnp.asarray(f, jnp.dtype(cfg.dtype))
        pb["frames"] = torch.from_numpy(f).to(getattr(torch, cfg.dtype))
    return rb, pb


def _reference_like(model, tree):
    """A reference tree as a list in the port's parameter order."""
    return [convert._reference_leaf(model, n, tree)
            for n, _ in model.named_parameters()]


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
SHAPES = [(7,), (3, 5), (2, 3, 4), (1,)]


def _ulps(a: torch.Tensor, b: np.ndarray) -> int:
    """Largest distance in bf16 ulps (same-sign values)."""
    bits = a.view(torch.int16).numpy().astype(np.int32)
    want = torch.from_numpy(b).to(torch.bfloat16).view(torch.int16)
    return int(np.abs(bits - want.numpy().astype(np.int32)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_equals_the_reference(dtype):
    """Five steps on a random tree, gradients large enough that the global
    clip scales them (step 1 and 3) and small enough that it does not."""
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    sched = dict(peak_lr=1e-2, warmup=2, total=6)
    ropt = RO.AdamW(lr=RO.cosine_schedule(**sched))
    opt = O.AdamW(lr=O.cosine_schedule(**sched))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rparams = {str(i): jnp.asarray(a, jdt) for i, a in enumerate(p0)}
    params = [torch.from_numpy(a.copy()).to(tdt) for a in p0]
    rstate, state = ropt.init(rparams), opt.init(params)
    for step in range(5):
        scale = (3.0, 0.05, 2.0, 0.01, 0.1)[step]
        g = [(rng.standard_normal(s) * scale).astype(np.float32)
             for s in SHAPES]
        rparams, rstate, rgn = ropt.update(
            {str(i): jnp.asarray(a, jdt) for i, a in enumerate(g)}, rstate,
            rparams)
        params, state, gn = opt.update([torch.from_numpy(a).to(tdt)
                                        for a in g], state, params)
        np.testing.assert_allclose(float(gn), float(rgn), rtol=1e-6)
        assert int(state.step) == int(rstate.step) == step + 1
        for i, p in enumerate(params):
            want = np.asarray(rparams[str(i)], np.float32)
            if dtype == "float32":
                np.testing.assert_allclose(p.numpy(), want, rtol=1e-6,
                                           atol=1e-12)
            else:
                assert _ulps(p, want) <= 1, (step, i)
            for mine, ref in ((state.m[i], rstate.m[str(i)]),
                              (state.v[i], rstate.v[str(i)])):
                assert mine.dtype == torch.float32
                np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                           rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("warmup,total", [(10, 12), (10, 50), (0, 20),
                                          (3, 100)])
def test_cosine_schedule_equals_the_reference(warmup, total):
    ref = RO.cosine_schedule(3e-3, warmup, total)
    mine = O.cosine_schedule(3e-3, warmup, total)
    steps = range(total + 6)
    want = np.array([np.float32(ref(jnp.int32(s))) for s in steps])
    got = np.array([float(mine(torch.tensor(s, dtype=torch.int32)))
                    for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == (0.0 if warmup else 3e-3 * np.float32(1.0))


def test_adamw_converges_on_a_quadratic():
    """`tests/test_train_infra.py::test_adamw_converges_quadratic`."""
    opt = O.AdamW(lr=lambda s: 0.1, weight_decay=0.0)
    w = torch.tensor([5.0, -3.0])
    state = opt.init([w])
    for _ in range(200):
        _, state, _ = opt.update([2 * w], state, [w])
    assert float(w.abs().max()) < 0.05


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["granite-3-2b", "chameleon-34b",
                                  "deepseek-moe-16b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b", "whisper-tiny"])
def test_gradient_equals_jax_value_and_grad(arch):
    """One gradient a family (dense, vlm, moe at a dropless capacity, ssm,
    hybrid, encdec with frames) against ``jax.value_and_grad`` of the
    reference's ``loss_fn``."""
    rcfg, cfg, rp, model = _pair(arch, **_dropless(arch))
    rb, pb = _batch(cfg)
    rl, rg = jax.jit(jax.value_and_grad(
        lambda p: RM.loss_fn(rcfg, p, rb)))(rp)
    ps = list(model.parameters())
    assert all(p.requires_grad for p in ps)
    loss = M.loss_fn(cfg, model, pb)
    grads = torch.autograd.grad(loss, ps)
    np.testing.assert_allclose(float(loss.detach()), float(rl), rtol=1e-5)
    for g, want in zip(grads, _reference_like(model, _np(rg))):
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-moe-16b",
                                  "mamba2-2.7b", "whisper-tiny"])
def test_remat_modes_give_bit_identical_gradients(arch):
    """``cfg.remat`` is memory, not arithmetic: none, dots and full give
    the same loss and gradients, bit for bit (the MoE's autograd
    Functions recomputed inside a checkpoint too)."""
    out = {}
    for mode in ("none", "dots", "full"):
        cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32",
                                  remat=mode)
        model = M.init_params(cfg, seed=0, device="cpu")
        _, pb = _batch(cfg)
        loss = M.loss_fn(cfg, model, pb)
        out[mode] = (loss.detach(), torch.autograd.grad(
            loss, list(model.parameters())))
    for mode in ("dots", "full"):
        assert torch.equal(out[mode][0], out["none"][0]), mode
        for a, b in zip(out[mode][1], out["none"][1]):
            assert torch.equal(a, b), mode


def test_remat_rejects_an_unknown_mode():
    cfg = dataclasses.replace(configs.get_smoke("granite-3-2b"),
                              remat="some")
    with pytest.raises(ValueError, match="none, dots or full"):
        M.forward(cfg, M.init_params(cfg, device="cpu"),
                  {"tokens": torch.zeros((1, 4), dtype=torch.long)})


# ---------------------------------------------------------------------------
# the MoE's gather-only autograd Functions
# ---------------------------------------------------------------------------
def _moe_plan(seed=0, t=24):
    """A sorted-dispatch plan with drops (capacity 8 for 24 x 2 pairs over
    4 experts, skewed to expert 0) and its reference index arrays."""
    cfg = dataclasses.replace(configs.get_smoke("deepseek-moe-16b"),
                              n_experts=4, top_k=2, capacity_factor=0.5)
    rng = np.random.default_rng(seed)
    top_i = torch.from_numpy(np.stack(
        [rng.choice(4, 2, replace=False, p=[0.55, 0.15, 0.15, 0.15])
         for _ in range(t)]))
    plan = MOE.sorted_dispatch_plan(cfg, top_i)
    assert not bool(plan["keep"].all()), "the plan must drop pairs"
    return cfg, plan, {k: jnp.asarray(v.numpy()) for k, v in plan.items()
                       if k != "cap"}


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def test_moe_functions_equal_jax_vjp_of_the_reference_primitives():
    """Forward and backward of each Function against ``jax.vjp`` of the
    reference primitive on the same index arrays: the gathers exact, the
    sums over k within 1e-6."""
    cfg, plan, rplan = _moe_plan()
    k, e, cap, d = cfg.top_k, cfg.n_experts, plan["cap"], 5
    j = plan["order"].shape[1]
    t = j // k
    slots = [plan[n] for n in ("inv_slot", "flat_slot", "keep")]
    rslots = [rplan[n] for n in ("inv_slot", "flat_slot", "keep")]
    perm = [plan["tok_sorted"], plan["inv_perm"]]
    rperm = [rplan["tok_sorted"], rplan["inv_perm"]]
    cases = [
        (MOE.SortedToSlots, RMOE._sorted_to_slots, (1, j + 1, d),
         (1, e * cap, d), slots, rslots, ()),
        (MOE.SlotsToSorted, RMOE._slots_to_sorted, (1, e * cap, d),
         (1, j, d), slots, rslots, ()),
        (MOE.TokensToSorted, RMOE._tokens_to_sorted, (1, t, d), (1, j, d),
         perm, rperm, (k,)),
        (MOE.SortedToTokens, RMOE._sorted_to_tokens, (1, j, d), (1, t, d),
         perm, rperm, (k,)),
    ]
    for n, (fn, rfn, shape, out_shape, idx, ridx, lead) in enumerate(cases):
        x, ct = _rand(shape, 10 + n), _rand(out_shape, 20 + n)
        if fn is MOE.SortedToSlots:
            x[:, -1] = 0.0                       # the zero pad row
        xt = torch.from_numpy(x).requires_grad_()
        y = fn.apply(*lead, xt, *idx)
        (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(ct))
        ry, vjp = jax.vjp(lambda a: rfn(*lead, a, *ridx), jnp.asarray(x))
        (rdx,) = vjp(jnp.asarray(ct))
        sums = {MOE.SortedToTokens: "forward", MOE.TokensToSorted: "backward"}
        tol = dict(rtol=1e-6, atol=1e-6)
        if sums.get(fn) == "forward":
            np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry),
                                       **tol)
        else:
            np.testing.assert_array_equal(y.detach().numpy(), np.asarray(ry))
        if sums.get(fn) == "backward":
            np.testing.assert_allclose(dx.numpy(), np.asarray(rdx), **tol)
        else:
            np.testing.assert_array_equal(dx.numpy(), np.asarray(rdx))


def test_moe_functions_pass_gradcheck_in_float64():
    """Each Function's mirror gather is its true vector-Jacobian product
    (the pad row of `SortedToSlots` enters through the zero pad, as in
    the dispatch)."""
    cfg, plan, _ = _moe_plan(seed=1, t=12)
    k, e, cap = cfg.top_k, cfg.n_experts, plan["cap"]
    j = plan["order"].shape[1]
    slots = [plan[n] for n in ("inv_slot", "flat_slot", "keep")]
    perm = [plan["tok_sorted"], plan["inv_perm"]]
    d = 3
    fns = [
        (lambda a: MOE.SortedToSlots.apply(MOE._pad_row(a), *slots), (1, j, d)),
        (lambda a: MOE.SlotsToSorted.apply(a, *slots), (1, e * cap, d)),
        (lambda a: MOE.TokensToSorted.apply(k, a, *perm), (1, j // k, d)),
        (lambda a: MOE.SortedToTokens.apply(k, a, *perm), (1, j, d)),
    ]
    for n, (fn, shape) in enumerate(fns):
        x = torch.from_numpy(_rand(shape, 30 + n, np.float64)
                             ).requires_grad_()
        assert torch.autograd.gradcheck(fn, (x,)), n


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _pipes(cfg, global_batch=4, seq=32):
    pc = dict(vocab=cfg.vocab, seq_len=seq, global_batch=global_batch)
    return (rpipe.TokenPipeline(rpipe.PipelineConfig(**pc)),
            pipeline.TokenPipeline(pipeline.PipelineConfig(**pc),
                                   device="cpu"))


def _opts(total=20):
    return (RO.AdamW(lr=RO.cosine_schedule(3e-3, warmup=2, total=total)),
            O.AdamW(lr=O.cosine_schedule(3e-3, warmup=2, total=total)))


def _close_step(metrics, rmetrics, model, rparams, lr_sum):
    """The step tolerance (module docstring); ``lr_sum``: the learning
    rates of the steps so far, summed."""
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), float(rmetrics[k]),
                                   rtol=STEP_RTOL, err_msg=k)
    for (name, p), want in zip(model.named_parameters(),
                               _reference_like(model, _np(rparams))):
        d = np.abs(p.detach().numpy() - want)
        assert d.max() <= 2 * lr_sum, (name, d.max())
        assert np.mean(d > PARAM_ATOL) <= PARAM_SHARE, (name, d.max())


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_equal_the_reference(microbatches):
    """granite-3-2b-smoke in float32: three steps on the token pipeline's
    batches from the same weights; loss, grad norm, lr and params."""
    rcfg, cfg, rp, model = _pair("granite-3-2b")
    ropt, opt = _opts()
    rpipe_, pipe = _pipes(cfg)
    rstate = RTS.TrainState(rp, ropt.init(rp))
    state = TS.TrainState(model, opt.init(model))
    rstep = jax.jit(RTS.make_train_step(rcfg, ropt, microbatches))
    step = TS.make_train_step(cfg, opt, microbatches)
    lr_sum = 0.0
    for s in range(3):
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray,
                                                rpipe_.batch(s)))
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in pipe.batch(s).items()})
        lr_sum += float(rm["lr"])
        _close_step(m, rm, state.params, rstate.params, lr_sum)
    assert int(state.opt.step) == 3


def test_two_microbatches_equal_one():
    """The port's ``microbatches=2`` against its own ``microbatches=1``:
    the same mean loss and update, to the float32 step tolerance."""
    cfg = dataclasses.replace(configs.get_smoke("granite-3-2b"),
                              dtype="float32")
    _, opt = _opts()
    _, pipe = _pipes(cfg)
    out = []
    for mb in (1, 2):
        model = M.init_params(cfg, seed=0, device="cpu")
        state = TS.TrainState(model, opt.init(model))
        state, m = TS.make_train_step(cfg, opt, mb)(
            state, {k: torch.from_numpy(v) for k, v in pipe.batch(0).items()})
        out.append((m, [p.detach().clone() for p in model.parameters()]))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(out[1][0][k]), float(out[0][0][k]),
                                   rtol=STEP_RTOL)
    for a, b in zip(out[0][1], out[1][1]):
        d = np.abs(b.numpy() - a.numpy())
        assert d.max() <= 2 * float(out[0][0]["lr"])
        assert np.mean(d > PARAM_ATOL) <= PARAM_SHARE


def test_eval_step_is_the_loss_without_a_graph():
    cfg = dataclasses.replace(configs.get_smoke("granite-3-2b"),
                              dtype="float32")
    model = M.init_params(cfg, seed=0, device="cpu")
    _, pb = _batch(cfg)
    loss = TS.make_eval_step(cfg)(model, pb)
    assert not loss.requires_grad
    assert torch.equal(loss, M.loss_fn(cfg, model, pb).detach())


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------
def _stepped_state(cfg, seed, steps, pipe, opt):
    model = M.init_params(cfg, seed=seed, device="cpu")
    state = TS.TrainState(model, opt.init(model))
    step = TS.make_train_step(cfg, opt)
    for s in range(steps):
        state, _ = step(state, {k: torch.from_numpy(v)
                                for k, v in pipe.batch(s).items()})
    return state


def _flat(state):
    return [t.detach().clone() for _, t in CK._flatten(state)]


@pytest.mark.parametrize("async_", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip(tmp_path, dtype, async_):
    """A stepped `TrainState` saved and restored into one drawn from
    another seed: every tensor equal, bf16 through its uint16 bits."""
    cfg = dataclasses.replace(configs.get_smoke("granite-3-2b"), dtype=dtype)
    _, opt = _opts()
    _, pipe = _pipes(cfg)
    state = _stepped_state(cfg, 0, 1, pipe, opt)
    want = _flat(state)
    th = CK.save(str(tmp_path), 1, state, extra={"arch": cfg.name},
                 async_=async_)
    if th is not None:
        th.join(timeout=60)
        assert not th.is_alive()
    other = _stepped_state(cfg, 1, 0, pipe, opt)
    assert CK.latest_step(str(tmp_path)) == 1
    got = CK.restore(str(tmp_path), 1, other)
    assert got is other
    for a, b in zip(_flat(got), want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_copies_the_state_before_its_thread_writes(tmp_path):
    """The optimizer updates tensors in place: an async save must hold the
    values of the step it was given, not a later one."""
    cfg = dataclasses.replace(configs.get_smoke("granite-3-2b"),
                              dtype="float32")
    _, opt = _opts()
    _, pipe = _pipes(cfg)
    state = _stepped_state(cfg, 0, 1, pipe, opt)
    want = _flat(state)
    th = CK.save(str(tmp_path), 1, state)
    with torch.no_grad():
        for _, t in CK._flatten(state):
            t.add_(1)
    th.join(timeout=60)
    got = CK.restore(str(tmp_path), 1, _stepped_state(cfg, 1, 0, pipe, opt))
    assert all(torch.equal(a, b) for a, b in zip(_flat(got), want))


def test_checkpoint_tmp_dir_is_never_the_latest_and_a_wrong_tree_raises(
        tmp_path):
    cfg = dataclasses.replace(configs.get_smoke("granite-3-2b"),
                              dtype="float32")
    _, opt = _opts()
    _, pipe = _pipes(cfg)
    state = _stepped_state(cfg, 0, 0, pipe, opt)
    CK.save(str(tmp_path), 5, state, async_=False)
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert CK.latest_step(str(tmp_path)) == 5
    assert CK.latest_step(str(tmp_path / "absent")) is None
    with open(tmp_path / "step_00000005" / "manifest.json") as f:
        assert '"step": 5' in f.read()
    other = dataclasses.replace(configs.get_smoke("starcoder2-3b"),
                                dtype="float32")
    wrong = _stepped_state(other, 0, 0, pipe, opt)
    with pytest.raises(ValueError, match="structure mismatch"):
        CK.restore(str(tmp_path), 5, wrong)


def test_resume_from_a_checkpoint_equals_the_uninterrupted_run(tmp_path):
    """k = 2 steps, save, restore into a state drawn from another seed,
    then m = 2 more: bit-identical to 4 uninterrupted steps."""
    cfg = dataclasses.replace(configs.get_smoke("granite-3-2b"),
                              dtype="float32")
    _, opt = _opts()
    _, pipe = _pipes(cfg)
    whole = _flat(_stepped_state(cfg, 0, 4, pipe, opt))
    state = _stepped_state(cfg, 0, 2, pipe, opt)
    CK.save(str(tmp_path), 1, state).join(timeout=60)
    state = CK.restore(str(tmp_path), 1, _stepped_state(cfg, 7, 0, pipe, opt))
    step = TS.make_train_step(cfg, opt)
    for s in (2, 3):
        state, _ = step(state, {k: torch.from_numpy(v)
                                for k, v in pipe.batch(s).items()})
    assert all(torch.equal(a, b) for a, b in zip(_flat(state), whole))


def test_a_reference_run_continues_in_the_port():
    """The reference's state after k = 2 steps, converted, stepped once by
    the port: its (k+1)-th step within the step tolerance."""
    rcfg, cfg, rp, _ = _pair("granite-3-2b")
    ropt, opt = _opts()
    rpipe_, pipe = _pipes(cfg)
    rstep = jax.jit(RTS.make_train_step(rcfg, ropt))
    rstate = RTS.TrainState(rp, ropt.init(rp))
    for s in range(2):
        rstate, _ = rstep(rstate, jax.tree.map(jnp.asarray, rpipe_.batch(s)))
    state = convert.train_state_from_reference(cfg, jax.tree.map(
        np.asarray, rstate), "cpu")
    assert int(state.opt.step) == 2
    rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, rpipe_.batch(2)))
    state, m = TS.make_train_step(cfg, opt)(
        state, {k: torch.from_numpy(v) for k, v in pipe.batch(2).items()})
    _close_step(m, rm, state.params, rstate.params, float(rm["lr"]))
    for mine, tree in ((state.opt.m, rstate.opt.m), (state.opt.v,
                                                     rstate.opt.v)):
        for a, b in zip(mine, _reference_like(state.params, _np(tree))):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# fault tolerance (a copy of the reference's policy code)
# ---------------------------------------------------------------------------
def _ledger_trace(mod):
    led = mod.HeartbeatLedger(4, straggler_factor=2.0, dead_after=3)
    out = []
    for step in range(6):
        for h in range(4):
            if h == 3 and step > 1:
                continue                      # host 3 dies after step 1
            now = step * 1.0 + (1.5 if h == 2 and step == 5 else 0.0)
            led.beat(h, step, now=now)
        out.append((led.median_step_time(), led.classify(step, now=step
                                                         + 0.5)))
    out.append(led.classify(5, now=9.0))
    return out


def test_fault_tolerance_equals_the_reference():
    assert _ledger_trace(FT) == _ledger_trace(RFT)
    for args in [((2, 16, 16), ("pod", "data", "model"), 3, 8),
                 ((1, 16, 16), ("pod", "data", "model"), 1, 8),
                 ((16, 16), ("data", "model"), 4, 8),
                 ((1, 4), ("data", "model"), 1, 1)]:
        assert FT.shrink_mesh_shape(*args) == RFT.shrink_mesh_shape(*args)
    for dead in (0, 1, 3):
        plans = []
        for mod in (FT, RFT):
            led = mod.HeartbeatLedger(4)
            for h in range(4):
                led.beat(h, 0 if h < dead else 10, now=0.0)
            plans.append(mod.plan_recovery(led, 10, (2, 2), ("data",
                                                             "model"),
                                           hosts_per_pod=2, ckpt_latest=7))
        assert dataclasses.asdict(plans[0]) == dataclasses.asdict(
            plans[1]) if plans[1] else plans[0] is None


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------
def _driver(*args):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], env=env,
        capture_output=True, text=True, timeout=600)


def test_train_driver_trains_checkpoints_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    args = ("--arch", "granite-3-2b", "--smoke", "--device", "cpu",
            "--steps", "12", "--ckpt-dir", ck, "--ckpt-every", "5")
    out = _driver(*args)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    losses = [float(ln.split()[3]) for ln in lines if ln.startswith("step")]
    final = float(lines[-1].split()[-1])
    assert len(losses) == 2 and final < losses[0], out.stdout
    assert "s/step" in lines[0] and "gnorm" in lines[0]
    assert sorted(os.listdir(ck)) == ["step_00000005", "step_00000010"]
    out = _driver(*args, "--resume")
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0] == "resumed from step 10"
    assert out.stdout.splitlines()[-1].startswith("done: final loss")


def test_train_driver_refuses_the_encdec_family():
    out = _driver("--arch", "whisper-tiny", "--smoke", "--device", "cpu")
    assert out.returncode == 2
    assert "no 'frames'" in out.stderr
