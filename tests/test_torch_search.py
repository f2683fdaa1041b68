"""The port's last-mile searches vs the reference's, on bounds from a real
RMI build."""
import jax

jax.config.update("jax_enable_x64", True)

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import base as rbase
from repro.core import search as rsearch
from repro.data import sosd as rsosd
from repro_torch.core import search
from repro_torch.kernels.common import encode_keys

DATASETS = ("amzn", "face", "osm", "wiki")


@functools.lru_cache(maxsize=None)
def _cell(ds: str):
    keys = rsosd.generate(ds, 20_000, seed=3)
    q = np.concatenate([
        rsosd.make_queries(keys, 2_000, seed=5, present_frac=0.6),
        np.array([0, 1, keys[0], keys[-1], 2**64 - 1], np.uint64)])
    b = rbase.REGISTRY["rmi"](keys, branching=1024)
    lo, hi = b.lookup(b.state, jnp.asarray(q))
    return keys, q, np.asarray(lo), np.asarray(hi), b.meta["max_err"]


def test_search_fns_names_match():
    assert tuple(search.SEARCH_FNS) == tuple(rsearch.SEARCH_FNS)


@pytest.mark.parametrize("last_mile", ["binary", "linear", "interpolation"])
@pytest.mark.parametrize("ds", DATASETS)
def test_last_mile_matches_reference(ds, last_mile):
    keys, q, lo, hi, max_err = _cell(ds)
    got = search.SEARCH_FNS[last_mile](
        encode_keys(keys, "cpu"), encode_keys(q, "cpu"),
        torch.tensor(lo), torch.tensor(hi), max_err)
    ref = rsearch.SEARCH_FNS[last_mile](
        jnp.asarray(keys), jnp.asarray(q), jnp.asarray(lo), jnp.asarray(hi),
        max_err)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(keys, q))


def test_linear_chunks_wide_windows():
    """Windows wider than the chunk are counted chunk by chunk."""
    keys, q, lo, hi, _ = _cell("wiki")
    got = search.bounded_linear(encode_keys(keys, "cpu"),
                                encode_keys(q[:300], "cpu"),
                                torch.zeros(300, dtype=torch.int64), None,
                                len(keys) + 1, chunk=4096)
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(keys, q[:300]))


@pytest.mark.parametrize("ds", ["face", "osm"])
def test_full_binary(ds):
    keys, q, *_ = _cell(ds)
    got = search.full_binary(encode_keys(keys, "cpu"), encode_keys(q, "cpu"))
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(keys, q))
    ref = rsearch.full_binary(jnp.asarray(keys), jnp.asarray(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_upper_bound_side():
    keys, q, lo, hi, max_err = _cell("amzn")
    got = search.bounded_binary(encode_keys(keys, "cpu"),
                                encode_keys(q, "cpu"),
                                torch.zeros(len(q), dtype=torch.int64),
                                torch.full((len(q),), len(keys) - 1),
                                len(keys), side="right")
    np.testing.assert_array_equal(got.numpy(),
                                  np.searchsorted(keys, q, side="right"))
