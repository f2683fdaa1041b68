"""Port foundations vs the reference: key codec, u32 planes, branchless LB."""
import jax

jax.config.update("jax_enable_x64", True)  # uint64 keys in the reference

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import common as rcommon
from repro.kernels.rmi_lookup import ref as rref
from repro_torch.kernels import common

EXTREMES = np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 1], dtype=np.uint64)


def test_split_encoded_tensor_matches_numpy_planes():
    """`key_halves` splits encoded keys into the reference's u32 planes."""
    rng = np.random.default_rng(1)
    a = np.concatenate([rng.integers(0, 2**64 - 1, 1000, dtype=np.uint64),
                        EXTREMES])
    hi, lo = common.key_halves(common.encode_keys(a, "cpu"))
    rhi, rlo = rcommon.split_u64(a)
    np.testing.assert_array_equal(hi.numpy(), rhi.astype(np.int64))
    np.testing.assert_array_equal(lo.numpy(), rlo.astype(np.int64))
    assert ((hi.numpy().astype(np.uint64) << np.uint64(32))
            | lo.numpy().astype(np.uint64) == a).all()


def test_codec_order_and_sentinels():
    enc = common.encode_keys(EXTREMES, "cpu")
    assert enc.dtype == torch.int64
    assert enc.tolist() == [-2**63, -2**63 + 1, -1, 0, 2**63 - 1]
    assert enc[-1].item() == torch.iinfo(torch.int64).max   # UINT64_MAX
    assert (common.decode_keys(enc) == EXTREMES).all()
    rng = np.random.default_rng(2)
    a = rng.integers(0, 2**64 - 1, 5000, dtype=np.uint64, endpoint=True)
    e = common.encode_keys(a, "cpu")
    order = np.argsort(a, kind="stable")
    assert (torch.argsort(e, stable=True).numpy() == order).all()
    assert (common.decode_keys(e) == a).all()


def test_codec_model_inputs():
    """f64 input == numpy's astype (one rounding); f32 input == the TPU
    kernel's own formula, at the sentinels and at random keys."""
    rng = np.random.default_rng(3)
    a = np.concatenate([EXTREMES, rng.integers(0, 2**64 - 1, 20000,
                                               dtype=np.uint64)])
    e = common.encode_keys(a, "cpu")
    np.testing.assert_array_equal(common.keys_to_f64(e).numpy(),
                                  a.astype(np.float64))
    assert common.keys_to_f64(e)[1].item() == 1.0   # small keys survive
    hi, lo = rcommon.split_u64(a)
    want = hi.astype(np.float32) * np.float32(2**32) + lo.astype(np.float32)
    np.testing.assert_array_equal(common.keys_to_f32(e).numpy(), want)
    st = type("S", (), dict(x0=np.float32(0.0), inv_range=np.float32(1.0)))
    np.testing.assert_array_equal(
        common.keys_to_f32(e).numpy(), np.asarray(rref.f32_u(st, jnp.asarray(a))))


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("index_dtype", ["int32", "int64"])
def test_branchless_lower_bound_matches_reference(index_dtype, side):
    rng = np.random.default_rng(4)
    keys = np.unique(rng.integers(0, 2**63, 3000, dtype=np.uint64))
    keys = np.concatenate([keys, keys[::7]])   # duplicates
    keys.sort()
    n = len(keys)
    q = np.concatenate([keys[rng.integers(0, n, 1500)],
                        rng.integers(0, 2**64 - 1, 500, dtype=np.uint64),
                        EXTREMES])
    width = 300
    lb = np.searchsorted(keys, q, side=side)
    lo = np.clip(lb - rng.integers(0, width - 1, len(q)), 0, n)
    hi = np.minimum(lo + width - 1, n)
    got = common.branchless_lower_bound(
        common.encode_keys(keys, "cpu"), common.encode_keys(q, "cpu"),
        torch.from_numpy(lo), torch.from_numpy(hi), width, side=side,
        index_dtype=getattr(torch, index_dtype))
    ref = rcommon.branchless_lower_bound(
        jnp.asarray(keys), jnp.asarray(q), jnp.asarray(lo), jnp.asarray(hi),
        width, side=side, index_dtype=getattr(jnp, index_dtype))
    assert got.dtype == getattr(torch, index_dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), lb)


def test_small_helpers_match_reference():
    for w in [0, 1, 2, 3, 127, 128, 129, 2047, 2048, 2049, 10**6, 2**31]:
        assert common.lb_steps(w) == rcommon.lb_steps(w)


def test_resolve_device():
    assert common.resolve_device("cpu") == torch.device("cpu")
