"""RadixSpline on fb-shaped keys (SOSD's ``fb_200M_uint64``: user IDs
uniform below 2^50 and 100 extreme outliers): the port's predict against
a plain spline predict written from its definition, the exact ranks, the
radix table the outliers collapse, and the spans of set-up and lookup."""
import numpy as np
import pytest
import torch

from lookup_bench import reference
from repro_torch.core import plan, radix_spline, spec
from repro_torch.kernels.common import encode_keys
from repro_torch.obs import trace

N = 100_000
OUTLIERS = 100
TOP = 2 ** 63 - 1


def fb_keys(n: int, seed: int, outliers: int = OUTLIERS) -> np.ndarray:
    """``n`` sorted unique uint64 keys: ``n - outliers`` distinct IDs
    uniform in ``[1, 2^50)`` and ``outliers`` uniform in ``[2^59,
    2^63 - 1)``."""
    rng = np.random.default_rng(seed)
    body = np.unique(rng.integers(1, 2 ** 50, size=int((n - outliers) * 1.05),
                                  dtype=np.uint64))
    body = np.sort(rng.choice(body, n - outliers, replace=False))
    far = np.unique(rng.integers(2 ** 59, TOP, size=outliers,
                                 dtype=np.uint64))
    assert far.shape[0] == outliers
    return np.concatenate([body, far])


@pytest.fixture(scope="module")
def keys():
    return fb_keys(N, 2 ** 31 + 28)


@pytest.fixture(scope="module")
def queries(keys):
    """Present keys, every outlier, queries in the gap between the body
    and the outliers and between outliers, uniform absent ones, and the
    ends: ``kmin - 1`` and ``2^63 - 1``."""
    rng = np.random.default_rng(7)
    present = rng.choice(keys, 5_000)
    body_top = keys[-OUTLIERS - 1]
    gap = rng.integers(int(body_top) + 1, int(keys[-OUTLIERS]), 500,
                       dtype=np.uint64)
    between = rng.integers(int(keys[-OUTLIERS]), TOP, 500, dtype=np.uint64)
    absent = rng.integers(1, 2 ** 50, 2_000, dtype=np.uint64)
    ends = np.array([int(keys[0]) - 1, int(keys[0]), int(body_top),
                     int(body_top) + 1, int(keys[-1]), int(keys[-1]) + 1,
                     TOP], np.uint64)
    return np.concatenate([present, keys[-OUTLIERS:], gap, between, absent,
                           ends])


def plain_predict(kx: torch.Tensor, ky: torch.Tensor, q: np.ndarray):
    """RadixSpline's prediction from its definition: the segment is the
    last knot ``<= q`` (`torch.searchsorted` over all the knots), and the
    position interpolates linearly between its two knots.  No radix
    table, no bounded search, no kernel."""
    qf = torch.from_numpy(q.astype(np.float64))
    m = kx.shape[0]
    seg = torch.clamp(torch.searchsorted(kx, qf, right=True) - 1, 0, m - 2)
    x0, x1, y0, y1 = kx[seg], kx[seg + 1], ky[seg], ky[seg + 1]
    dx = x1 - x0
    t = torch.where(dx > 0, (qf - x0) / torch.where(dx == 0, 1.0, dx), 0.0)
    t = torch.clamp(t, 0.0, 1.0)
    return y0 + t * (y1 - y0)


@pytest.mark.parametrize("radix_bits", [16, 18])
def test_predict_equals_the_plain_spline_bit_for_bit(keys, queries,
                                                     radix_bits):
    b = radix_spline.build(keys, eps=32, radix_bits=radix_bits,
                           device="cpu")
    # the outliers stretch the range to 63 bits
    assert radix_spline.radix_shape(keys, radix_bits) == (
        radix_bits, 63 - radix_bits)
    got = radix_spline.predict(b.state, encode_keys(queries, "cpu"))
    want = plain_predict(b.state["kx"], b.state["ky"], queries)
    assert got.dtype == torch.float64
    assert torch.equal(got, want)


@pytest.mark.parametrize("radix_bits", [16, 18])
def test_torch_ranks_equal_the_reference(keys, queries, radix_bits):
    b = spec.build(spec.IndexSpec("radix_spline",
                                  {"eps": 32, "radix_bits": radix_bits}),
                   keys, device="cpu")
    p = plan.lower(b, encode_keys(keys, "cpu"))
    got = p.compile("torch")(encode_keys(queries, "cpu"))
    raw_keys = torch.from_numpy(keys.view(np.int64))
    raw_q = torch.from_numpy(queries.view(np.int64))
    assert bool((raw_q >= 0).all())
    want = reference.lower_bound(raw_keys, raw_q)
    assert reference.wrong_ranks(got, want) == 0
    # the ends: below the keys, the body's top and the gap above it, the
    # last outlier and past it
    assert want[-7:].tolist() == [0, 0, N - OUTLIERS - 1, N - OUTLIERS,
                                  N - 1, N, N]


def test_knot_windows_show_the_table_the_outliers_collapse(keys):
    """Over 2^18 buckets the outliers leave the body in the lowest 32
    (a shift of 45): few buckets hold knots, and the widest window is the
    build's ``radix_max_gap``.  Without them the same body spreads over
    the table."""
    b = radix_spline.build(keys, eps=4, radix_bits=18, device="cpu")
    assert b.state["shift"] == 45
    q = encode_keys(keys, "cpu")
    slo, shi = radix_spline.knot_windows(b.state, q)
    assert bool((shi >= slo).all())
    assert int((shi - slo).max()) == b.meta["radix_max_gap"]
    counts = plan.window_counts(slo, shi)
    assert counts["queries"] == N
    assert counts["width_sum"] == int((shi - slo + 1).sum())
    table = b.state["table"]
    filled = int((table[1:] > table[:-1]).sum())
    assert filled <= 32 + OUTLIERS
    assert b.meta["radix_max_gap"] * 64 > b.meta["knots"]

    body = keys[:-OUTLIERS]
    spread = radix_spline.build(body, eps=4, radix_bits=18, device="cpu")
    assert spread.meta["radix_max_gap"] * 10 < b.meta["radix_max_gap"]
    wide = plan.window_counts(*radix_spline.knot_windows(
        spread.state, encode_keys(body, "cpu")))
    assert wide["steps_sum"] * 2 < counts["steps_sum"]


def test_a_recorder_sees_the_fit_and_the_predict_spans_in_order(keys,
                                                                 queries):
    rec = trace.SpanRecorder()
    with trace.recording(rec):
        b = spec.build(spec.IndexSpec("radix_spline",
                                      {"eps": 32, "radix_bits": 18}),
                       keys, device="cpu")
        p = plan.lower(b, encode_keys(keys, "cpu"))
        out = p.compile("cuda")(encode_keys(queries, "cpu"))
    np.testing.assert_array_equal(out.numpy(),
                                  np.searchsorted(keys, queries))
    spans = rec.spans()

    def named(name):
        return [s for s in spans if s.name == name]

    def inside(child, parent):
        return (parent.t0 <= child.t0
                and child.t0 + child.dur <= parent.t0 + parent.dur)

    (fit,), (lookup,), (pred,) = (named("index.fit"), named("lookup"),
                                  named("lookup.predict"))
    for child in ("fit.host", "fit.verify"):
        (s,) = named(child)
        assert inside(s, fit)
    assert named("fit.host")[0].t0 < named("fit.verify")[0].t0
    assert inside(pred, lookup)
    read = [s for s in spans if s.name.startswith("rs.")
            and inside(s, pred)]
    assert [s.name for s in sorted(read, key=lambda s: s.t0)] == [
        "rs.radix", "rs.knots", "rs.interp"]
    # the build's check runs the same predict under fit.verify
    assert all(inside(s, named("fit.verify")[0]) or inside(s, pred)
               for s in spans if s.name.startswith("rs."))
