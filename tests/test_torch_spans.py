"""The port's spans (`repro_torch.obs.trace.span`) at their sites in the
index's set-up and read path, their mirror onto the profiler's clock, and
the window counter (`LookupPlan.searched_windows`, `window_counts`)."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import plan, spec
from repro_torch.data import sosd
from repro_torch.kernels.common import encode_keys
from repro_torch.kernels.rmi_lookup import ref as rmi_ref
from repro_torch.obs import trace

#: (index, hyper, fused) whose spans are checked: RMI and PGM take their
#: fused path's plain version on the CPU (PGM's runs the torch descent,
#: outside ``lookup.predict``), PGM unfused the predict then the search
PLANS = [("rmi", {"branching": 256}, None),
         ("pgm", {"eps": 16, "top_cutoff": 4}, None),
         ("pgm", {"eps": 16, "top_cutoff": 4}, False)]
IDS = ["rmi", "pgm", "pgm-unfused"]
#: read-path spans of one call of each plan's compiled cuda lookup on the
#: CPU, beside ``lookup``, by id
READ_SPANS = {"rmi": set(), "pgm": {"pgm.top", "pgm.level1", "pgm.leaf"},
              "pgm-unfused": {"lookup.predict", "pgm.top", "pgm.level1",
                              "pgm.leaf", "lookup.search"}}


@pytest.fixture(scope="module")
def keys():
    return sosd.generate("amzn", 20_000, seed=1)


@pytest.fixture(scope="module")
def queries(keys):
    return sosd.make_queries(keys, 3_000, seed=2)


def setup_and_lookup(name, hyper, keys, queries, fused=None):
    """Build, lower and compile ``name`` on the CPU, and run one lookup
    of the cuda backend's callable; returns the plan and the ranks."""
    b = spec.build(spec.IndexSpec(name, hyper), keys, device="cpu")
    p = plan.lower(b, encode_keys(keys, "cpu"))
    out = p.compile("cuda", fused)(encode_keys(queries, "cpu"))
    np.testing.assert_array_equal(out.numpy(), np.searchsorted(keys, queries))
    return p, out


def inside(child, parent) -> bool:
    return (parent.t0 <= child.t0
            and child.t0 + child.dur <= parent.t0 + parent.dur
            and child.tid == parent.tid)


@pytest.mark.parametrize("name,hyper,fused", PLANS, ids=IDS)
def test_with_tracing_off_each_site_costs_one_guard(monkeypatch, request,
                                                    keys, queries, name,
                                                    hyper, fused):
    """No recorder and no profiler: nothing is recorded, no
    `record_function` is entered, and every site returns the one shared
    no-op after asking the profiler once."""
    entered, asked = [], []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: entered.append(a))
    enabled = torch.autograd._profiler_enabled
    monkeypatch.setattr(trace, "_profiler_enabled",
                        lambda: asked.append(1) or enabled())
    p, _ = setup_and_lookup(name, hyper, keys, queries, fused)
    fn = p.compile("cuda", fused)
    asked.clear()
    fn(encode_keys(queries, "cpu"))
    assert entered == []
    assert trace._CURRENT.get() is None
    # one guard a site: ``lookup`` and the path's own read spans
    assert len(asked) == 1 + len(READ_SPANS[request.node.callspec.id])
    assert trace.span("lookup", queries=1) is trace._NULL
    assert trace.maybe_span(None, "serve") is trace._NULL


@pytest.mark.parametrize("name,hyper,fused", PLANS, ids=IDS)
def test_a_recorder_gets_the_setup_and_read_spans_nested(request, keys,
                                                         queries, name,
                                                         hyper, fused):
    read = READ_SPANS[request.node.callspec.id]
    rec = trace.SpanRecorder()
    with trace.recording(rec) as installed:
        assert installed is rec and trace._CURRENT.get() is rec
        setup_and_lookup(name, hyper, keys, queries, fused)
    assert trace._CURRENT.get() is None
    spans = rec.spans()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    refit = {"refit.stage1", "refit.bins", "refit.verify"} \
        if name == "rmi" else set()
    assert set(by) == ({"index.fit", "fit.host", "fit.verify",
                        "index.lower", "index.compile", "lookup"}
                       | refit | read)
    assert all(len(v) == 1 for v in by.values())
    one = {k: v[0] for k, v in by.items()}
    assert one["index.fit"].args == {"index": name}
    assert one["lookup"].args == {"queries": queries.shape[0]}
    assert all(s.cat == "index" for s in spans)
    for child in ("fit.host", "fit.verify"):
        assert inside(one[child], one["index.fit"])
    for child in refit:
        assert inside(one[child], one["index.compile"])
    for child in read:
        assert inside(one[child], one["lookup"])
    if "lookup.predict" in read:
        for child in ("pgm.top", "pgm.level1", "pgm.leaf"):
            assert inside(one[child], one["lookup.predict"])
        assert not inside(one["lookup.search"], one["lookup.predict"])
    # set-up, then the lookup
    assert one["index.compile"].t0 + one["index.compile"].dur \
        <= one["lookup"].t0
    # outside `recording` nothing more is written
    n = rec.n_recorded
    setup_and_lookup(name, hyper, keys, queries, fused)
    assert rec.n_recorded == n


def test_maybe_span_mirrors_onto_a_running_profiler():
    rec = trace.SpanRecorder()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.maybe_span(rec, "compile", cat="compile", key=1):
            torch.ones(4).sum()
        with trace.maybe_span(None, "admission"):
            pass
    names = [e.name for e in prof.events()]
    assert {"compile", "admission"} <= set(names)
    assert [s.name for s in rec.spans()] == ["compile"]
    assert rec.spans()[0].args == {"key": 1}


@pytest.mark.parametrize("name,hyper,fused", PLANS, ids=IDS)
def test_under_a_cpu_profiler_read_spans_lie_inside_lookup(request, tmp_path,
                                                           keys, queries,
                                                           name, hyper,
                                                           fused):
    b = spec.build(spec.IndexSpec(name, hyper), keys, device="cpu")
    fn = plan.lower(b, encode_keys(keys, "cpu")).compile("cuda", fused)
    q = encode_keys(queries, "cpu")
    fn(q)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn(q)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    ann = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("ph") == "X"]
    lookups = [e for e in ann if e["name"] == "lookup"]
    assert len(lookups) == 1
    l0 = float(lookups[0]["ts"])
    l1 = l0 + float(lookups[0]["dur"])
    found = {e["name"] for e in ann
             if l0 <= float(e["ts"]) <= float(e["ts"]) + float(e["dur"])
             <= l1 + 1e-3}
    assert READ_SPANS[request.node.callspec.id] | {"lookup"} <= found


def clipped_numpy(lo, hi, n, max_width):
    """``lookup.cuh``'s ``clip_window`` in numpy: ``(start, width)``."""
    start = np.clip(lo, 0, n - 1)
    last = np.minimum(np.minimum(start + max_width - 1, hi), n)
    return start, np.maximum(last - start + 1, 0)


def steps_numpy(width):
    w = np.maximum(width, 1).astype(np.float64)
    return np.ceil(np.log2(w)).astype(np.int64)


@pytest.mark.parametrize("name,hyper", [PLANS[0][:2], PLANS[1][:2],
                                        ("pgm", {"eps": 64})],
                         ids=["rmi", "pgm", "pgm-64"])
def test_the_window_counter_equals_numpy(keys, queries, name, hyper):
    """RMI (fused): the windows from the f32 state's ``err`` table;
    PGM (fused too): from the plan's bounds, which ``pgm_lookup`` searches;
    each clipped as the kernel clips it."""
    p, _ = setup_and_lookup(name, hyper, keys, queries)
    q = encode_keys(queries, "cpu")
    n = keys.shape[0]
    if name == "rmi":
        st = p._cache["_rmi_f32_state"]
        pred, err, _ = rmi_ref.rmi_infer_ref(st, q)
        pred = np.clip(pred.numpy().astype(np.float64), -1.0, n + 1.0)
        err = err.numpy().astype(np.int64)
        lo = np.clip(np.floor(pred).astype(np.int64) - err, 0, n)
        hi = np.clip(np.ceil(pred).astype(np.int64) + err, 0, n)
        max_width = st.max_err
    else:
        lo, hi = (t.numpy().astype(np.int64)
                  for t in p.bounds.predict(p.bounds.state, q))
        max_width = p.bounds.max_err
    start, width = clipped_numpy(lo, hi, n, max_width)
    got_lo, got_hi = p.searched_windows(q)
    np.testing.assert_array_equal(got_lo.numpy(), start)
    np.testing.assert_array_equal((got_hi - got_lo + 1).numpy(), width)
    # every answer lies in its window
    lb = np.searchsorted(keys, queries)
    assert ((start <= lb) & (lb <= start + width - 1)).all()
    counts = plan.window_counts(got_lo, got_hi)
    assert counts == {"queries": queries.shape[0],
                      "width_sum": int(width.sum()),
                      "steps_sum": int(steps_numpy(width).sum())}


def test_search_steps_is_ceil_log2_and_counts_empty_windows():
    width = torch.tensor([0, 1, 2, 3, 4, 5, 1023, 1024, 1025, 2 ** 30 + 1])
    edges = torch.tensor([1 << j for j in range(31)])
    assert plan.search_steps(width, edges).tolist() == [
        0, 0, 1, 2, 2, 3, 10, 10, 11, 31]
    lo = torch.tensor([5, 0, 9])
    hi = torch.tensor([4, 0, 12])               # empty, one key, four keys
    assert plan.window_counts(lo, hi) == {"queries": 3, "width_sum": 5,
                                          "steps_sum": 2}


def test_point_only_plans_have_no_windows(keys):
    b = spec.build(spec.IndexSpec("robin_hash", {}), keys, device="cpu")
    p = plan.lower(b, encode_keys(keys, "cpu"))
    with pytest.raises(ValueError, match="point-only"):
        p.searched_windows(encode_keys(keys[:4], "cpu"))
