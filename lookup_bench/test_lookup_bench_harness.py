"""A whole run of every cell at a small size on the CPU (the port's plain
versions stand in for its kernels), the faults and the control that
``correct`` has to catch, and the reading of a traced window."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from lookup_bench import control, devtrace, harness

ROOT = Path(__file__).resolve().parents[1]
BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"n_keys": 200_000, "batch": 4096, "pool_batches": 4}


def run(cell, trace=False, device="cpu", **kw):
    return harness.run_cell(cell, 2 ** 31 + 17, 0.2, trace, device,
                            time.perf_counter(), scale=SMALL, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_a_small_run_is_correct_and_reports_the_cells_metrics(cell):
    r = run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["value"] >= 0 for m in r["metrics"].values())
    assert list(r)[-1] == "checks"
    assert r["checks"]["wrong_ranks"]["value"] == 0
    assert r["checks"]["checked_batches"]["value"] == min(
        harness.RESERVOIR, r["attempted"])


@pytest.mark.parametrize("cell", CELLS[:2])
def test_a_traced_run_reports_the_host_side_layer_metrics(cell):
    r = run(cell, trace=True)
    assert r["correct"]
    # on the CPU the trace holds no device work: no device metric
    assert {"index_build_s", "index_mib", "host_call_us"} <= set(
        r["metrics"])
    assert "lookup_roofline" not in r["metrics"]
    assert r["device"]["window_s"] > 0


@pytest.mark.parametrize("fault", ["control", "altered", "half", "stale"])
@pytest.mark.parametrize("cell", CELLS[:2])
def test_correct_comes_out_false_under_the_control_and_each_fault(
        cell, fault):
    r = run(cell, wrap=control.planted(fault), program=fault != "control")
    assert not r["correct"]
    assert r["checks"]["wrong_ranks"]["value"] > 0
    assert r["failed"] > 0


def test_a_seed_makes_the_queries_and_the_configuration_the_keys():
    seen = []

    def grab(fn, inputs):
        seen.append((inputs["raw_keys"].clone(), inputs["raw_pool"].clone()))
        return fn

    for seed in (5, 5, 2 ** 31 + 6):
        harness.run_cell(CELLS[0], seed, 0.05, False, "cpu",
                         time.perf_counter(), scale=SMALL, wrap=grab)
    assert torch.equal(seen[0][0], seen[1][0])
    assert torch.equal(seen[0][1], seen[1][1])
    assert torch.equal(seen[0][0], seen[2][0])
    assert not torch.equal(seen[0][1], seen[2][1])


def test_the_window_keeps_in_flight_batches_and_a_seeded_sample():
    pool = torch.arange(12).reshape(4, 3)
    calls = []
    keep = harness.Reservoir(3, 1, 3, "cpu")
    w = harness.drive(lambda q: calls.append(q) or q.clone(), pool, 2,
                      batches=10, keep=keep)
    assert w.batches == 10 and w.slots == [k % 4 for k in range(10)]
    assert len(w.latency_s) == 10 and len(keep.kept) == 3
    for slot, got, given in keep.rows():
        assert torch.equal(got, pool[slot]) and given == 3
    again = harness.Reservoir(3, 1, 3, "cpu")
    harness.drive(lambda q: q.clone(), pool, 2, batches=10, keep=again)
    assert again.kept == keep.kept
    # answers that are short or long are held as given
    odd = harness.Reservoir(2, 1, 3, "cpu")
    odd(0, 0, torch.tensor([7]))
    odd(1, 1, torch.arange(5))
    assert [(s, g.tolist(), n) for s, g, n in odd.rows()] == [
        (0, [7], 1), (1, [0, 1, 2], 5)]


def test_devtrace_reads_busy_time_and_names_idle_gaps():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "window", "ts": 0,
         "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "call", "ts": 0,
         "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "wait", "ts": 40,
         "dur": 60},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 5, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 60,
         "dur": 30},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "call", "ts": 0,
         "dur": 100},
    ]
    s = devtrace.summarize(ev)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(65e-6)      # [5, 40] + [60, 90]
    assert s["kernel_s"] == pytest.approx(35e-6)
    assert s["device_ops"][0] == ["k1", pytest.approx(50e-6)]
    assert s["idle_gaps"] == [["wait", pytest.approx(20e-6)],
                              ["wait", pytest.approx(10e-6)],
                              ["call", pytest.approx(5e-6)]]
    assert devtrace.summarize(ev[1:]) == {}


def test_run_exits_without_a_result_where_there_is_no_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "lookup_bench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS[:2])
def test_on_the_card_a_small_run_is_correct_and_a_fault_is_not(card, cell):
    r = run(cell, trace=True, device=card)
    assert r["correct"]
    assert {"lookup_roofline", "device_idle_pct"} <= set(r["metrics"])
    assert 0 < r["metrics"]["lookup_roofline"]["value"] < 100
    bad = run(cell, device=card, wrap=control.planted("altered"))
    assert not bad["correct"]
    json.dumps(r)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_a_seed_makes_the_same_inputs_at_full_size(card, cell):
    """Float scans and atomics on the card can sum in another order on
    every run; the inputs may not depend on it."""
    from lookup_bench import keys, traffic

    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    config = harness.load_config(entry["config"])
    mix = traffic.load(entry["traffic"])
    made = []
    for _ in range(2):
        k = keys.load(config["dataset"]).generate(
            config["n_keys"], harness.generator(config["key_seed"],
                                                harness.KEYS, card), card)
        pool = traffic.make_pool(k, mix, harness.generator(
            2 ** 31 + 3, harness.QUERIES, card), mix["batch"], 2)
        made.append((k, pool))
    assert torch.equal(made[0][0], made[1][0])
    assert torch.equal(made[0][1], made[1][1])
