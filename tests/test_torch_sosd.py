"""The port's numpy copies of the SOSD surrogates and query streams are
bit-identical to the reference's."""
import numpy as np
import pytest

from repro.data import sosd as rsosd
from repro.workloads import make_point_queries as r_make_point_queries
from repro_torch.data import sosd
from repro_torch.workloads import make_point_queries

DATASETS = ("amzn", "face", "osm", "wiki")


def test_dataset_tables_match():
    assert tuple(sosd.DATASETS) == tuple(rsosd.DATASETS)
    assert sosd.SOSD_SOURCES == rsosd.SOSD_SOURCES


@pytest.mark.parametrize("n,seed", [(5_000, 0), (20_000, 7)])
@pytest.mark.parametrize("ds", DATASETS)
def test_generate_bit_identical(ds, n, seed):
    got = sosd.generate(ds, n, seed=seed)
    want = rsosd.generate(ds, n, seed=seed)
    assert got.dtype == np.uint64 and len(got) == n
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("present_frac", [0.5, 0.8])
@pytest.mark.parametrize("ds", DATASETS)
def test_make_queries_bit_identical(ds, present_frac):
    keys = rsosd.generate(ds, 10_000, seed=3)
    got = sosd.make_queries(keys, 4_001, seed=5, present_frac=present_frac)
    want = rsosd.make_queries(keys, 4_001, seed=5, present_frac=present_frac)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


def test_make_point_queries_near_uint64_max():
    keys = np.array([1, 2**64 - 2000, 2**64 - 1], dtype=np.uint64)
    np.testing.assert_array_equal(make_point_queries(keys, 999, seed=9),
                                  r_make_point_queries(keys, 999, seed=9))


def test_load_real_matches_reference(tmp_path):
    raw = np.unique(np.random.default_rng(0).integers(
        0, 2**63, 3_000, dtype=np.uint64))
    path = tmp_path / sosd.SOSD_SOURCES["wiki"]
    with open(path, "wb") as f:
        np.array([len(raw)], "<u8").tofile(f)
        raw.astype("<u8").tofile(f)
    for n in (len(raw), 1_000):
        np.testing.assert_array_equal(
            sosd.load_real("wiki", n, str(tmp_path)),
            rsosd.load_real("wiki", n, str(tmp_path)))
    with pytest.raises(FileNotFoundError):
        sosd.load_real("osm", 10, str(tmp_path))
