"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests run on ONE device;
only launch/dryrun.py requests 512 placeholder devices."""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture(scope="session")
def datasets():
    from repro.data import sosd

    n = 60_000
    return {name: sosd.generate(name, n, seed=7) for name in sosd.DATASETS}


@pytest.fixture(scope="session")
def queries(datasets):
    from repro.data import sosd

    return {name: sosd.make_queries(keys, 8_000, seed=11, present_frac=0.6)
            for name, keys in datasets.items()}
