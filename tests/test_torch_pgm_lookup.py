"""The fused PGM lookup (``csrc/pgm_lookup.cu``) on the CPU: its plain
version against the unfused cuda path, the torch backend and
np.searchsorted at depths 1 to 5, a per-query transcription of the
kernel's loop against the torch descent (windows that miss the answer
included), the state `LookupPlan.to` carries, and the constants and
argument layout the binding shares with the source.  The kernel itself is
held against its plain version on the card (`tests/test_torch_cuda.py`)."""
import ctypes
import functools
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import pgm, plan, spec
from repro_torch.data import sosd
from repro_torch.kernels.bounded_search.ops import NEAR_BLOCKS
from repro_torch.kernels.common import encode_keys
from repro_torch.kernels.pgm_lookup import kernel, ops

SRC = (Path(kernel.__file__).resolve().parents[2] / "csrc"
       / "pgm_lookup.cu").read_text()
N_KEYS, N_Q = 20_000, 6_000
EDGES = np.array([0, 1, 2 ** 53 + 1, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 2,
                  2 ** 64 - 1], np.uint64)
#: (dataset, hyper, depth): the fit is the reference's, so each depth is
#: fixed; ``u64`` keys are uniform over all of uint64, nearly all > 2^53
CASES = [("wiki", {"eps": 64}, 1),
         ("wiki", {"eps": 8, "eps_internal": 2, "top_cutoff": 16}, 2),
         ("wiki", {"eps": 4, "eps_internal": 1, "top_cutoff": 4}, 3),
         ("wiki", {"eps": 2, "eps_internal": 1, "top_cutoff": 2}, 4),
         ("amzn", {"eps": 64}, 1),
         ("amzn", {"eps": 8, "eps_internal": 2, "top_cutoff": 16}, 2),
         ("amzn", {"eps": 4, "eps_internal": 1, "top_cutoff": 4}, 4),
         ("amzn", {"eps": 2, "eps_internal": 1, "top_cutoff": 2}, 5),
         ("u64", {"eps": 16, "eps_internal": 2, "top_cutoff": 8}, 2)]
IDS = [f"{ds}-depth{d}" for ds, _, d in CASES]


@functools.lru_cache(maxsize=None)
def _keys(ds: str) -> np.ndarray:
    if ds == "u64":
        rng = np.random.default_rng(9)
        return np.unique(rng.integers(0, 2 ** 64 - 1, N_KEYS, np.uint64,
                                      endpoint=True))
    return sosd.generate(ds, N_KEYS, seed=1)


def _queries(keys: np.ndarray) -> np.ndarray:
    """Present and absent keys (uniform over the key range and over all
    of uint64), each key's neighbours, and the codec's edges."""
    rng = np.random.default_rng(len(keys))
    present = keys[rng.integers(0, len(keys), N_Q // 3)]
    inside = rng.integers(int(keys[0]), int(keys[-1]), N_Q // 3,
                          dtype=np.uint64, endpoint=True)
    anywhere = rng.integers(0, 2 ** 64 - 1, N_Q // 6, np.uint64,
                            endpoint=True)
    near = np.concatenate([keys[:50] - np.uint64(1), keys[-50:] + np.uint64(1)])
    return np.concatenate([present, inside, anywhere, near, EDGES])


@functools.lru_cache(maxsize=None)
def _plan(ds: str, hyper: tuple):
    keys = _keys(ds)
    b = spec.build(spec.IndexSpec("pgm", dict(hyper)), keys, device="cpu")
    return keys, plan.lower(b, encode_keys(keys, "cpu"))


@pytest.mark.parametrize("ds,hyper,depth", CASES, ids=IDS)
def test_fused_plain_equals_unfused_torch_and_searchsorted(ds, hyper, depth):
    keys, p = _plan(ds, tuple(sorted(hyper.items())))
    assert p.bounds.state["n"] == len(keys)
    assert len(p.bounds.state["levels"]) == depth
    assert p.fused is plan.FUSED_LOWERERS["pgm"]
    q = _queries(keys)
    qt = encode_keys(q, "cpu")
    got = p.compile("cuda")(qt)
    assert got.dtype == torch.int64 and "_pgm_state" in p._cache
    for fn in (p.compile("cuda", fused=False), p.compile("torch")):
        assert torch.equal(got, fn(qt))
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(keys, q))


def _kernel_windows(st: ops.PGMState, q: np.ndarray):
    """``pgm_lookup.cu``'s descent for each uint64 query, transcribed line
    for line in Python floats (IEEE doubles, each operation rounded once,
    no FMA): the leaf windows ``(lo, hi)`` the kernel hands B1."""
    state = st.state
    levels = [tuple(t.tolist() for t in level) for level in state["levels"]]
    depth, n, errs, e0 = len(levels), state["n"], state["errs"], state["e0"]

    def clip(v, lo, hi):
        return lo if v < lo else (hi if v > hi else v)

    def pred_of(level, seg, qf, hi_clamp):
        ax, ay, sl = level
        return min(max(ay[seg] + sl[seg] * (qf - ax[seg]), -1.0), hi_clamp)

    out = []
    for key in q.tolist():
        qf = float(key >> 32) * 4294967296.0 + float(key & 0xFFFFFFFF)
        top = levels[-1][0]
        a, count = 0, len(top)
        while count > 0:                       # top_count
            half = count >> 1
            right = top[a + half] <= qf
            a, count = (a + half + 1, count - half - 1) if right \
                else (a, half)
        seg = clip(a - 1, 0, len(top) - 1)
        for lvl in range(depth - 1, 0, -1):
            below = levels[lvl - 1][0]
            mb = len(below)
            pred = pred_of(levels[lvl], seg, qf, float(mb) + 1.0)
            lo = clip(math.floor(pred) - errs[lvl], 0, mb - 1)
            hi = clip(math.ceil(pred) + errs[lvl], 0, mb - 1)
            count = max(hi + 1 - lo, 0)
            for _ in range(st.steps[lvl]):     # bounded_upper
                step = count >> 1
                idx = lo + step
                right = below[clip(idx, 0, mb - 1)] <= qf and idx < mb
                lo, count = (lo + step + 1, count - step - 1) if right \
                    else (lo, step)
            seg = clip(lo - 1, 0, mb - 1)
        pred = pred_of(levels[0], seg, qf, float(n) + 1.0)
        out.append((clip(math.floor(pred) - e0, 0, n),
                    clip(math.ceil(pred) + e0, 0, n)))
    return np.array(out, np.int64).reshape(-1, 2)


@pytest.mark.parametrize("narrowed", [False, True],
                         ids=["verified", "narrowed"])
@pytest.mark.parametrize("ds,hyper,depth", CASES, ids=IDS)
def test_the_kernels_loop_equals_the_torch_descent(ds, hyper, depth,
                                                   narrowed):
    """The transcribed kernel and `pgm.descend` give the same windows; with
    every error narrowed to 0 (``narrowed``), the internal levels' windows
    miss their answers and both still agree step for step."""
    keys, p = _plan(ds, tuple(sorted(hyper.items())))
    state = p.bounds.state
    if narrowed:
        state = dict(state, errs=(0,) * len(state["errs"]), e0=0)
    st = ops.prepare_state(state, p.bounds.max_err)
    q = _queries(keys)[::3]
    lo, hi = pgm.descend(st.state, encode_keys(q, "cpu"))
    want = _kernel_windows(st, q)
    np.testing.assert_array_equal(lo.numpy(), want[:, 0])
    np.testing.assert_array_equal(hi.numpy(), want[:, 1])
    if narrowed:
        # the narrowed windows do miss: the check above covers that case
        assert (np.searchsorted(keys, q) > want[:, 1]).any()


def test_the_fused_lookup_is_one_call_of_pgm_lookup(monkeypatch):
    keys = _keys("wiki")
    calls = []
    real = ops.pgm_lookup

    def spy(st, data, queries):
        out = real(st, data, queries)
        calls.append(out)
        return out

    monkeypatch.setattr(ops, "pgm_lookup", spy)
    p = plan.lower(spec.build(spec.IndexSpec("pgm", {"eps": 32}), keys,
                              device="cpu"), encode_keys(keys, "cpu"))
    q = _queries(keys)
    got = p.compile("cuda")(encode_keys(q, "cpu"))
    assert len(calls) == 1 and got is calls[0]
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(keys, q))
    # the windows it searches are the plan's predict, clipped by max_err
    assert "pgm" not in plan.FUSED_WINDOWS


def test_plan_to_carries_the_derived_state():
    keys, p = _plan("amzn", (("eps", 8), ("eps_internal", 2),
                             ("top_cutoff", 16)))
    p.compile("cuda")
    st = p._cache["_pgm_state"]
    assert st.state is p.bounds.state  # no copy
    meta = p.to("meta")
    moved = meta._cache["_pgm_state"]
    assert moved is not st and moved.model is None
    assert all(t.device.type == "meta" for level in moved.state["levels"]
               for t in level)
    assert {k: v for k, v in moved.state.items() if k != "levels"} \
        == {k: v for k, v in st.state.items() if k != "levels"}
    assert (moved.max_err, moved.steps) == (st.max_err, st.steps)
    assert not any(isinstance(k, tuple) for k in meta._cache)


def test_prepare_state_refuses_what_the_kernel_cannot_descend():
    _, p = _plan("wiki", (("eps", 64),))
    state = p.bounds.state
    deep = dict(state, levels=list(state["levels"]) * (kernel.MAX_DEPTH + 1),
                errs=tuple(state["errs"]) * (kernel.MAX_DEPTH + 1))
    with pytest.raises(ValueError, match="fused=False"):
        ops.prepare_state(deep, p.bounds.max_err)
    with pytest.raises(ValueError, match="2\\^31"):
        ops.prepare_state(dict(state, n=2 ** 31), p.bounds.max_err)
    ax, ay, sl = state["levels"][-1]
    flipped = dict(state, levels=[(ax.flip(0), ay, sl)])
    with pytest.raises(ValueError, match="ascending"):
        ops.prepare_state(flipped, p.bounds.max_err)


def _struct_fields(name: str):
    body = re.search(r"struct %s \{(.*?)\};" % name, SRC, re.S).group(1)
    return re.findall(r"(\w+)(?:\[\w+\])?;", body)


def test_binding_constants_and_layout_are_the_sources():
    assert int(re.search(r"constexpr int kMaxDepth = (\d+);", SRC)
               .group(1)) == kernel.MAX_DEPTH
    assert int(re.search(r"constexpr int kNearBlocks = (-?\d+);", SRC)
               .group(1)) == NEAR_BLOCKS["bounded_search", torch.int64]
    assert "window_lower_bound<kNearBlocks>" in SRC
    assert _struct_fields("Level") == [f for f, _ in kernel.Level._fields_]
    assert _struct_fields("Model") == [f for f, _ in kernel.Model._fields_]
    assert kernel.Model.level.size == ctypes.sizeof(kernel.Level) \
        * kernel.MAX_DEPTH
    st = ops.prepare_state(_plan("wiki", (("eps", 64),))[1].bounds.state, 64)
    mod = kernel.model_of(st)
    state = st.state
    assert (mod.depth, mod.n, mod.e0, mod.max_err) \
        == (len(state["levels"]), state["n"], state["e0"], 64)
    assert mod.level[0].m == state["levels"][0][0].shape[0]
    assert mod.level[0].ax == state["levels"][0][0].data_ptr()
