"""The fb cell's inputs and the pipelined cell's traffic: the fb
generator's shape, the traffic file, and a small run of each new cell on
the CPU."""
import time

import pytest
import torch

from lookup_bench import harness, keys, traffic

N = 100_000
SMALL = {"n_keys": 200_000, "batch": 4096, "pool_batches": 4}
CELLS = ["fb200M-radix_spline.uniform", "books200M-rmi.pipelined"]


def fb(n=N, seed=5, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    return keys.load("fb").generate(n, gen, device)


def assert_fb_shape(k, n):
    assert k.dtype == torch.int64 and k.shape == (n,)
    assert bool((k[1:] > k[:-1]).all())
    assert int(k[0]) >= 1 and int(k[-1]) < 2 ** 63 - 1
    outliers = k >= 2 ** 59
    assert int(outliers.sum()) == 100
    assert bool(outliers[-100:].all())
    assert int(k[-101]) < 2 ** 50


def test_fb_gives_the_body_and_the_outliers():
    assert_fb_shape(fb(), N)
    assert_fb_shape(fb(1_000), 1_000)
    # the body is uniform below 2^50: its median sits near 2^49
    body = fb()[:-100].double()
    assert abs(float(body.median()) / 2 ** 49 - 1) < 0.02


def test_fb_repeats_for_a_seed():
    assert torch.equal(fb(5_000, 2 ** 31 + 9), fb(5_000, 2 ** 31 + 9))
    assert not torch.equal(fb(5_000, 1), fb(5_000, 2))


def test_pipelined_traffic_keeps_four_batches_queued():
    mix = traffic.load("pipelined")
    assert mix["in_flight"] == 4
    assert (mix["batch"], mix["pool_batches"], mix["present_share"],
            mix["ranks"], mix["absent_margin"]) == (
        10_000_000, 8, 0.8, {"dist": "uniform"}, 1000)
    assert mix == {**traffic.load("uniform"), "in_flight": 4,
                   "source": mix["source"]}


@pytest.mark.parametrize("cell", CELLS)
def test_a_small_traced_run_of_each_new_cell_is_correct(cell):
    r = harness.run_cell(cell, 2 ** 31 + 28, 0.2, True, "cpu",
                         time.perf_counter(), scale=SMALL)
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["wrong_ranks"]["value"] == 0
    assert {"index_build_s", "index_mib", "host_call_us"} <= set(
        r["metrics"])


@pytest.mark.cuda
def test_on_the_card_fb_has_its_shape_at_full_size(card):
    config = harness.load_config("fb200M-radix_spline")
    n = config["n_keys"]
    k = keys.load(config["dataset"]).generate(
        n, harness.generator(config["key_seed"], harness.KEYS, card), card)
    assert_fb_shape(k, n)
