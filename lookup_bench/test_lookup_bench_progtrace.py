"""Reading the port's own spans out of a traced window (`progtrace`):
kernels put down to the innermost port span through their launch's
correlation, the device's idle time cut by the ``lookup`` spans, and a
small run of every cell on the CPU."""
import time

import pytest

from lookup_bench import harness, progtrace

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]
SMALL = {"n_keys": 200_000, "batch": 4096, "pool_batches": 4}


def x(cat, name, ts, dur, tid=1, **args):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "tid": tid}
    if args:
        ev["args"] = args
    return ev


def test_attribute_puts_each_kernel_under_its_innermost_span():
    ev = [
        x("user_annotation", "window", 0, 100),
        x("user_annotation", "call", 0, 40),
        # two calls of the port's lookup; the second's search launches
        x("user_annotation", "lookup", 1, 29),
        x("user_annotation", "lookup.predict", 2, 10),
        x("user_annotation", "pgm.top", 3, 4),
        x("user_annotation", "lookup.search", 14, 10),
        x("user_annotation", "kernel.launch", 15, 5),
        x("user_annotation", "lookup", 60, 20),
        x("user_annotation", "kernel.launch", 61, 3),
        # another thread's span over the same time is not the launcher's
        x("user_annotation", "pgm.leaf", 0, 100, tid=2),
        x("cuda_runtime", "cudaLaunchKernel", 4, 1, correlation=7),
        x("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=8),
        x("cuda_runtime", "cudaLaunchKernel", 16, 1, correlation=9),
        x("cuda_runtime", "cudaLaunchKernel", 62, 1, correlation=10),
        x("cuda_runtime", "cudaMemcpyAsync", 50, 1, correlation=11),
        x("kernel", "top_k", 5, 10, tid=7, correlation=7),
        x("kernel", "predict_k", 15, 5, tid=7, correlation=8),
        x("kernel", "search_k", 20, 8, tid=7, correlation=9),
        x("kernel", "fused_k", 70, 40, tid=7, correlation=10),
        x("gpu_memcpy", "copy", 51, 2, tid=7, correlation=11),
        x("gpu_user_annotation", "lookup", 5, 95, tid=7),
    ]
    got = progtrace.attribute(ev)
    assert got["calls"] == 2
    assert got["launches"] == 4          # the copy was launched outside
    assert got["window_s"] == pytest.approx(100e-6)
    assert got["by_span"] == {
        "kernel.launch": pytest.approx((8 + 30) * 1e-6),
        "pgm.top": pytest.approx(10e-6),
        "lookup.predict": pytest.approx(5e-6),
        "none": pytest.approx(2e-6)}
    # device busy [5, 28] and [51, 53] and [70, 100]; lookups [1, 30]
    # and [60, 80]: idle inside them 4 + 2 (first) and 10 (second)
    assert got["dispatch_idle_s"] == pytest.approx(16e-6)
    assert progtrace.attribute(ev[1:]) == {}


def test_attribute_reads_a_window_without_device_work():
    ev = [x("user_annotation", "window", 0, 50),
          x("user_annotation", "lookup", 10, 20)]
    got = progtrace.attribute(ev)
    assert got == {"calls": 1, "launches": 0,
                   "dispatch_idle_s": pytest.approx(20e-6),
                   "window_s": pytest.approx(50e-6), "by_span": {}}


@pytest.mark.parametrize("cell", CELLS)
def test_a_small_run_reads_the_spans_and_the_window_counter(cell):
    r = progtrace.run(cell, 2 ** 31 + 17, 0.05, 1, "cpu",
                      time.perf_counter(), scale=SMALL)
    assert r["spans"] and r["kind"] == "cpu"
    setup = r["setup_spans_s"]
    assert {"index.fit", "fit.host", "fit.verify", "index.lower",
            "index.compile"} <= set(setup)
    assert setup["index.fit"] < r["index_build_s"]
    assert [t["spans_on"] for t in r["turns"]] == [False, True]
    off, on = r["turns"]
    assert off["spans_recorded"] == 0
    assert on["spans_recorded"] >= on["batches"]
    assert r["program"]["calls"] == r["trace"]["batches"]
    assert r["program"]["launches"] == 0 and r["program"]["by_span"] == {}
    w = r["windows"]
    assert w["queries"] == SMALL["batch"] * SMALL["pool_batches"]
    assert w["width_sum"] >= w["queries"] and 0 < w["steps_sum"]
