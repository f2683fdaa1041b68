"""The inputs and the yardstick at small sizes on the CPU: the dataset
generators, the traffic generator, the reference, its control, the codec
and the roofline's byte count."""
import json
import math

import numpy as np
import pytest
import torch

from lookup_bench import codec, keys, reference, roofline, traffic

N = 100_000


def make_keys(dataset, n=N, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return keys.load(dataset).generate(n, gen, "cpu")


@pytest.mark.parametrize("dataset", ["books", "wiki_ts"])
def test_generators_give_n_sorted_unique_keys_below_2_63(dataset):
    k = make_keys(dataset)
    assert k.dtype == torch.int64 and k.shape == (N,)
    assert bool((k[1:] > k[:-1]).all())
    assert int(k[0]) >= 1


@pytest.mark.parametrize("dataset", ["books", "wiki_ts"])
def test_generators_repeat_for_a_seed(dataset):
    assert torch.equal(make_keys(dataset, 5000, 2 ** 31 + 9),
                       make_keys(dataset, 5000, 2 ** 31 + 9))
    assert not torch.equal(make_keys(dataset, 5000, 1),
                           make_keys(dataset, 5000, 2))


def test_books_has_the_lognormal_body_and_the_scale():
    from lookup_bench.datagen import books

    raw = books.draw(N, torch.Generator().manual_seed(5), "cpu")
    # scaled so that the largest draw is 2^62, and the draws distinct
    assert abs(float(raw.max()) - 2.0 ** 62) <= 2.0 ** 11
    assert keys.sorted_unique(raw).numel() > 0.999 * raw.numel()
    k = make_keys("books").double()
    # a lognormal(10, 2.2) body: ln keys spread over an interquartile
    # range of 2 * 0.6745 * 2.2 = 2.97, whatever the common scale
    q1, q3 = np.quantile(np.log(k.numpy()), [0.25, 0.75])
    assert 2.6 < q3 - q1 < 3.4


def test_wiki_ts_has_the_timestamp_gaps():
    from lookup_bench.datagen import wiki_ts

    raw = wiki_ts.draw(N, torch.Generator().manual_seed(5), "cpu")
    # whole seconds from 10^9, a quarter of them repeated
    assert int(raw[0]) >= 10 ** 9
    assert 0.70 < keys.sorted_unique(raw).numel() / raw.numel() < 0.82
    k = make_keys("wiki_ts").double()
    assert float(k[0]) >= 1e9
    # 1.4 N gaps of mean 2.5 E[1 / rate] = 2.5 / sqrt(1.8) = 1.86 s,
    # shortened by the bursts: about 2.6 s a kept key
    mean_gap = float((k[-1] - k[0]) / (N - 1))
    assert 2.3 < mean_gap < 2.9


def test_finalize_cuts_to_n_and_refuses_too_few_draws():
    gen = torch.Generator().manual_seed(3)
    with pytest.raises(ValueError, match="draws too few"):
        keys.finalize(torch.tensor([5, 5, 7, 9, 9], dtype=torch.int64),
                      4, gen)
    same = keys.finalize(torch.tensor([9, 5, 7, 5], dtype=torch.int64),
                         3, gen)
    assert same.tolist() == [5, 7, 9]
    many = keys.finalize(torch.arange(100, dtype=torch.int64), 10, gen)
    assert many.shape == (10,) and bool((many[1:] > many[:-1]).all())


def pool_of(name, k, batch=20_000, pool_batches=3, seed=8):
    mix = traffic.load(name)
    gen = torch.Generator().manual_seed(seed)
    return traffic.make_pool(k, mix, gen, batch, pool_batches)


def test_uniform_traffic_has_the_stated_present_share():
    k = make_keys("books")
    pool = pool_of("uniform", k)
    assert pool.shape == (3, 20_000)
    for row in pool:
        pos = torch.searchsorted(k, row).clamp(max=N - 1)
        present = float((k[pos] == row).double().mean())
        assert 0.8 <= present < 0.805
        assert int(row.min()) >= int(k[0]) - 1000
        assert int(row.max()) < int(k[-1]) + 1000


def test_zipf_traffic_is_all_present_with_the_zipfian_head():
    n, size, theta = 10_000, 400_000, 0.99
    k = torch.arange(1, n + 1, dtype=torch.int64) * 3
    pool = pool_of("zipf", k, batch=size // 4, pool_batches=4)
    ranks = torch.searchsorted(k, pool.reshape(-1))
    assert bool((k[ranks] == pool.reshape(-1)).all())
    counts = torch.bincount(ranks, minlength=n).sort(descending=True).values
    w = np.arange(1, n + 1, dtype=np.float64) ** -theta
    for head in (1, 10, 100):
        want = w[:head].sum() / w.sum()
        got = float(counts[:head].sum()) / size
        assert abs(got - want) < 0.01, (head, got, want)
    # scrambled: the hottest key is not the first
    assert int(torch.bincount(ranks).argmax()) != 0


def test_traffic_files_name_a_source_and_no_unknown_key(tmp_path,
                                                       monkeypatch):
    mix = traffic.load("uniform")
    assert mix["source"] and mix["in_flight"] >= 1
    monkeypatch.setattr(traffic, "TRAFFIC", tmp_path)
    for extra, match in ((("sort_batches", True), "unknown keys"),
                         (("source", ""), "no source")):
        bad = dict(mix)
        bad[extra[0]] = extra[1]
        (tmp_path / "bad.json").write_text(json.dumps(bad))
        with pytest.raises(ValueError, match=match):
            traffic.load("bad")


def test_which_keys_are_hot_is_the_same_for_every_seed():
    k = make_keys("books", 20_000)
    hottest = [int(torch.mode(pool_of("zipf", k, seed=s).reshape(-1))[0])
               for s in (1, 2 ** 31 + 1)]
    assert hottest[0] == hottest[1]


def test_reference_equals_numpy_searchsorted():
    rng = np.random.default_rng(4)
    k = np.unique(rng.integers(0, 1 << 62, 50_000))
    q = np.concatenate([k[rng.integers(0, len(k), 3000)],
                        rng.integers(0, 1 << 62, 3000), [0, k[-1] + 1]])
    got = reference.lower_bound(torch.from_numpy(k), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(k, q))


def test_control_breaks_the_exact_rank_where_f32_rounds_keys_together():
    k = torch.arange(1 << 30, (1 << 30) + 4000, 3, dtype=torch.int64)
    q = k[::7] + 1
    exact = reference.lower_bound(k, q)
    assert reference.wrong_ranks(reference.lower_bound_f32(k, q), exact) > 0
    assert reference.wrong_ranks(exact, exact) == 0
    assert reference.wrong_ranks(exact[:10], exact) == exact.numel() - 10


def test_codec_is_the_ports():
    from repro_torch.kernels.common import encode_keys

    raw = torch.tensor([0, 1, 2 ** 40, 2 ** 62, 2 ** 63 - 1])
    got = codec.encode(raw)
    want = encode_keys(raw.numpy().astype(np.uint64), "cpu")
    assert torch.equal(got, want)
    assert torch.equal(codec.decode(got), raw)
    assert bool((got[1:] > got[:-1]).all())


def test_roofline_bytes_match_a_hand_count():
    # 10 keys, 4 to a 32-byte sector: sectors {0,1,2,3}, {4..7}, {8,9}
    ranks = torch.tensor([0, 3, 3, 5, 9, 10, 12])
    # ranks 10 and 12 clip to key 9: sectors 0, 1 and 2 hold answers
    assert roofline.answer_sector_bytes(10, ranks) == 3 * 32
    assert roofline.batch_bytes(10, ranks) == 7 * 16 + 3 * 32
    assert roofline.least_seconds(3.35e12, "NVIDIA H100 80GB HBM3") == 1.0
    assert roofline.least_seconds(1.0, "cpu") is None


def test_zipfian_weights_match_the_closed_form():
    n, theta = 1000, 0.99
    gen = torch.Generator().manual_seed(0)
    ranks = traffic.zipfian_ranks(gen, 200_000, n, "cpu", theta=theta,
                                  scramble=False)
    head = float((ranks == 0).double().mean())
    want = 1.0 / sum((i + 1) ** -theta for i in range(n))
    assert math.isclose(head, want, abs_tol=0.005)


@pytest.mark.cuda
@pytest.mark.parametrize("dataset", ["books", "wiki_ts"])
def test_on_the_card_the_generators_keep_their_shape_at_full_size(
        card, dataset):
    """At each configuration's own size and key seed: the draws stay
    distinct enough that every key comes from the stated distribution,
    and the keys have the stated scale and spread."""
    from lookup_bench import harness

    config = next(c for c in (harness.load_config(e["config"]) for e in
                              harness.load_benchmark()["workloads"])
                  if c["dataset"] == dataset)
    n, gen = config["n_keys"], keys.load(dataset)
    raw = gen.draw(n, harness.generator(config["key_seed"], harness.KEYS,
                                        card), card)
    distinct = keys.sorted_unique(raw).numel()
    del raw
    k = gen.generate(n, harness.generator(config["key_seed"], harness.KEYS,
                                          card), card).double()
    if dataset == "books":
        m = int(n * 1.25)
        assert distinct > 0.99 * (m + m // 20)
        assert abs(float(k[-1]) - 2.0 ** 62) <= 2.0 ** 11
        q1, q3 = torch.quantile(torch.log(k[::97]),
                                torch.tensor([0.25, 0.75], device=card,
                                             dtype=torch.float64)).tolist()
        assert 2.6 < q3 - q1 < 3.4
    else:
        assert n < distinct < 0.82 * int(n * 1.4)
        assert float(k[0]) >= 1e9
        assert 1.45e9 < float(k[-1]) < 1.6e9
        assert 2.3 < float((k[-1] - k[0]) / (n - 1)) < 2.9
