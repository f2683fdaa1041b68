"""Token serving in the port (`repro_torch.serve.{engine,kv_cache}` and the
driver's token mode) against the reference's `repro.serve`.

The engine is held in float32, where greedy decoding must emit the
reference's tokens exactly; the paged-KV bookkeeping and the learned slot
index are integer and must be bit-identical to the reference (and the
slot index to ``np.searchsorted``).

The reference engine's decode is made synchronous here: on the CPU
``jnp.asarray`` of its host ``lens`` aliases the numpy buffer, and the
engine advances ``lens`` while the dispatched step may still read it
(`src/repro/serve/engine.py:85-88`, `:101-111`), so its tokens varied
from run to run.  For the SSD families (mamba2, jamba) the oracle is each
request served alone by the reference: its batched engine lets every
slot's recurrent state advance on other slots' steps (ROADMAP C).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import model as RM
from repro.serve import engine as rengine
from repro.serve import kv_cache as rkv
from repro_torch import configs, convert
from repro_torch.kernels.bounded_search.ops import lower_bound_windows
from repro_torch.models import model as M
from repro_torch.serve import kv_cache
from repro_torch.serve.engine import ServeEngine


def _synchronous(ref):
    """The reference engine with each decode step waited for before the
    engine touches its host ``lens`` again."""
    decode = ref._decode
    ref._decode = lambda *a: jax.block_until_ready(decode(*a))
    return ref


def _weights(arch, dtype="float32"):
    rcfg = dataclasses.replace(rconfigs.get_smoke(arch), dtype=dtype)
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=dtype)
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    model = convert.decoder_from_reference(
        cfg, jax.tree.map(lambda a: np.asarray(a, np.float32), rp), "cpu")
    return rcfg, cfg, rp, model


def _engines(arch, dtype="float32", **kw):
    """The reference's engine and the port's, on the same weights."""
    rcfg, cfg, rp, model = _weights(arch, dtype)
    return (_synchronous(rengine.ServeEngine(rcfg, rp, **kw)),
            ServeEngine(cfg, model, device="cpu", **kw))


@pytest.mark.parametrize("arch", ["granite-3-2b", "starcoder2-3b",
                                  "deepseek-moe-16b", "mixtral-8x22b"])
def test_engine_emits_the_reference_tokens(arch):
    """`examples/serve_paged_kv.py`'s traffic: 6 requests over 4 slots,
    so slots are freed and re-admitted mid-run."""
    ref, port = _engines(arch, max_batch=4, max_seq=96, page_size=8)
    vocab = port.cfg.vocab
    for eng in (ref, port):
        rng = np.random.default_rng(0)
        for _ in range(6):
            eng.submit(list(rng.integers(2, vocab, rng.integers(3, 9))),
                       max_new=6)
    want, got = ref.run(max_steps=64), port.run(max_steps=64)
    assert got == want and len(got) == 6
    assert all(len(v) == 6 for v in got.values())
    np.testing.assert_array_equal(port.lens, ref.lens)
    np.testing.assert_array_equal(port.kv.table, ref.kv.table)
    assert port.kv.alloc.utilization == ref.kv.alloc.utilization
    # the example's second engine: the slot index of a live layout
    ref2, port2 = _engines(arch, max_batch=4, max_seq=96, page_size=8)
    for eng in (ref2, port2):
        for _ in range(3):
            eng.submit([2, 3, 4, 5], max_new=8)
        eng.step()
    slots = np.arange(16, dtype=np.int32)
    want = np.asarray(ref2.kv.slot_index().lookup(jnp.asarray(slots)))
    got = port2.kv.slot_index().lookup(torch.from_numpy(slots))
    np.testing.assert_array_equal(got.numpy(), want)


PROMPTS = ([5, 6, 7, 8], [9, 10, 11], [12, 13, 14, 15, 16])


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_recurrent_engine_serves_each_request_as_if_alone(arch):
    """Three requests over 2 slots (the third re-admits a freed slot):
    the port's batched tokens equal each request served alone by the
    reference (``max_batch=1``); the reference's batched tokens differ
    (its state leak).  Which tokens the weights give depends on whether
    another test module turned on ``jax_enable_x64`` in this process."""
    rcfg, cfg, rp, model = _weights(arch)
    kw = dict(max_seq=64, page_size=8)
    alone = []
    for prompt in PROMPTS:
        ref = _synchronous(rengine.ServeEngine(rcfg, rp, max_batch=1, **kw))
        ref.submit(prompt, max_new=5)
        alone.append(ref.run()[0])
    ref = _synchronous(rengine.ServeEngine(rcfg, rp, max_batch=2, **kw))
    port = ServeEngine(cfg, model, max_batch=2, device="cpu", **kw)
    for eng in (ref, port):
        for prompt in PROMPTS:
            eng.submit(prompt, max_new=5)
    got, leaked = port.run(), ref.run()
    assert [got[r] for r in range(3)] == alone
    assert [leaked[r] for r in range(3)] != alone


def test_engine_refuses_params_on_another_device():
    cfg = configs.get_smoke("granite-3-2b")
    params = M.init_params(cfg, device="meta")
    with pytest.raises(ValueError, match="serves on cpu"):
        ServeEngine(cfg, params, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_kv_cache_bookkeeping_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    ref = rkv.PagedKVCache(n_pages=64, page_size=4, max_seqs=6,
                           max_pages_per_seq=12)
    port = kv_cache.PagedKVCache(n_pages=64, page_size=4, max_seqs=6,
                                 max_pages_per_seq=12)
    live = set()
    for _ in range(300):
        free = [s for s in range(6) if s not in live]
        op = rng.integers(0, 3)
        if op == 0 and free:
            sid, n = int(rng.choice(free)), int(rng.integers(1, 14))
            for c in (ref, port):
                c.add_sequence(sid, n)
            live.add(sid)
        elif op == 1 and live:
            sid = int(rng.choice(sorted(live)))
            if ref.lens[sid] >= 47:
                continue
            for c in (ref, port):
                c.append_token(sid)
        elif op == 2 and live:
            sid = int(rng.choice(sorted(live)))
            for c in (ref, port):
                c.free_sequence(sid)
            live.discard(sid)
        np.testing.assert_array_equal(port.table, ref.table)
        np.testing.assert_array_equal(port.lens, ref.lens)
        assert port.pages == ref.pages
        assert port.alloc.free == ref.alloc.free
        assert port.alloc.owner == ref.alloc.owner
        ids = np.array(sorted(live) or [0])
        np.testing.assert_array_equal(port.gather_spec(ids),
                                      ref.gather_spec(ids))
    with pytest.raises(MemoryError):
        kv_cache.PageAllocator(2, 4).alloc(0, 3)


def _layout(name, rng):
    if name == "vllm_256":        # vLLM's max_num_seqs, lengths 1..8192
        return rng.integers(1, 8193, 256)
    if name == "equal":
        return np.full(64, 16)
    if name == "single":
        return np.array([37])
    if name == "one_long":        # half the tokens in the first sequence:
        lens = rng.integers(1, 40, 3000)    # the window is wider than 2048
        lens[0] = 60_000
        return lens
    raise ValueError(name)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("layout", ["vllm_256", "equal", "single",
                                    "one_long"])
def test_learned_slot_index_equals_the_reference(layout, seed):
    rng = np.random.default_rng(seed)
    lens = _layout(layout, rng)
    cum = np.concatenate([[0], np.cumsum(lens)])
    ref, port = rkv.LearnedSlotIndex(cum), kv_cache.LearnedSlotIndex(cum)
    assert (port.slope, port.err, port.n_req) == (ref.slope, ref.err,
                                                  ref.n_req)
    if layout == "one_long":
        assert 2 * port.err + 2 > 2048
    total = int(cum[-1])
    slots = np.unique(np.concatenate([
        rng.integers(0, total, 20_000), cum[:-1], np.maximum(cum[1:] - 1, 0),
        [0, total - 1]])).astype(np.int32)
    got = port.lookup(torch.from_numpy(slots))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.searchsorted(cum, slots, "right") - 1)
    # past the last live token, the reference's clip decides
    slots = np.concatenate([slots[::7], [total, total + 5]]).astype(np.int32)
    np.testing.assert_array_equal(
        port.lookup(torch.from_numpy(slots)).numpy(),
        np.asarray(ref.lookup(jnp.asarray(slots))))


def test_slot_index_needs_fewer_than_2_31_tokens():
    with pytest.raises(ValueError, match="2\\^31"):
        kv_cache.LearnedSlotIndex(np.array([0, 2 ** 30, 2 ** 31]))


@pytest.mark.parametrize("case", ["near_2_31", "width_1", "width_2_16",
                                  "empty"])
def test_bounded_search_plain_on_int32_keys(case):
    """B1's plain version (what the CPU runs) on int32 keys and queries."""
    rng = np.random.default_rng(3)
    hi = None
    if case == "near_2_31":
        keys = np.sort(rng.choice(2 ** 31 - 2 ** 20, 5_000, replace=False)
                       + 2 ** 20).astype(np.int32)
        keys[-1] = 2 ** 31 - 1
        q = np.concatenate([keys[::3], [2 ** 31 - 1, 0, -5]]).astype(np.int32)
        lo, width = np.maximum(np.searchsorted(keys, q) - 3, 0), 8
    else:
        keys = np.sort(rng.integers(-1000, 100_000, 4_000)).astype(np.int32)
        q = rng.integers(-2_000, 110_000, 3_000).astype(np.int32)
        lb = np.searchsorted(keys, q)
        width = 2 ** 16 if case == "width_2_16" else 1
        lo = np.maximum(lb - rng.integers(0, min(width, 4_001), len(q)), 0)
        if case == "empty":           # hi < lo: the window holds nothing
            lo = rng.integers(-3, len(keys), len(q))
            hi = torch.from_numpy((lo - 1).astype(np.int32))
    got = lower_bound_windows(torch.from_numpy(keys), torch.from_numpy(q),
                              torch.from_numpy(lo.astype(np.int32)), width,
                              hi)
    want = (np.clip(lo, 0, len(keys) - 1) if case == "empty"
            else np.searchsorted(keys, q))
    np.testing.assert_array_equal(got.numpy(), want)


def _driver(*args):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], env=env,
        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-moe-16b",
                                  "mamba2-2.7b", "jamba-1.5-large-398b",
                                  "mixtral-8x22b"])
def test_driver_serves_tokens_on_the_cpu(arch):
    out = _driver("--smoke", "--device", "cpu", "--requests", "4",
                  "--max-new", "4", "--arch", arch)
    assert out.returncode == 0, out.stderr
    assert f"serving {arch}-smoke" in out.stdout
    assert "16 tokens for 4 requests" in out.stdout
    assert "over 4 slots" in out.stdout


def test_driver_serves_the_encdec_family():
    """whisper-tiny, as the reference's driver serves it (its engine
    decodes with the cached encoder states at zero)."""
    out = _driver("--smoke", "--device", "cpu", "--requests", "4",
                  "--max-new", "4", "--arch", "whisper-tiny")
    assert out.returncode == 0, out.stderr
    assert "serving whisper-tiny-smoke (4 layers" in out.stdout
    assert "16 tokens for 4 requests" in out.stdout
