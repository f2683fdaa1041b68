"""The port's LM data path (`repro_torch.data.{pipeline,packing}`) against
the reference's (`repro.data`): the pipeline's batches bit for bit, the
packed index's lookups exact, the packed rows identical."""
import numpy as np
import pytest
import torch

from repro.data import packing as rpacking
from repro.data import pipeline as rpipeline
from repro_torch.data import packing, pipeline


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_token_pipeline_batches_equal_the_reference(n_hosts):
    """Several steps of every host's shard, at the train driver's shape
    and a vocabulary of granite-3-2b's size."""
    for host in range(n_hosts):
        cfg = dict(vocab=49155, seq_len=64, global_batch=8, seed=3,
                   host_id=host, n_hosts=n_hosts)
        ref = rpipeline.TokenPipeline(rpipeline.PipelineConfig(**cfg))
        mine = pipeline.TokenPipeline(pipeline.PipelineConfig(**cfg),
                                      device="cpu")
        np.testing.assert_array_equal(mine.doc_lens, ref.doc_lens)
        for step in (0, 1, 7, 1000):
            want, got = ref.batch(step), mine.batch(step)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])
        it, rit = iter(mine), iter(ref)
        for _ in range(2):
            np.testing.assert_array_equal(next(it)["tokens"],
                                          next(rit)["tokens"])


def test_packed_index_locate_equals_the_reference_and_the_oracle():
    """On the pipeline's documents: every document start, 0, the last
    offset, and 10,000 random offsets."""
    lens = pipeline.TokenPipeline(pipeline.PipelineConfig(
        vocab=512, seq_len=64, global_batch=8), device="cpu").doc_lens
    mine = packing.PackedIndex(lens, device="cpu")
    ref = rpacking.PackedIndex(lens)
    np.testing.assert_array_equal(mine.cum, ref.cum)
    assert mine.total == ref.total and mine.index.device.type == "cpu"
    rng = np.random.default_rng(0)
    offsets = np.concatenate([mine.cum[:-1], [0, mine.total - 1],
                              rng.integers(0, mine.total, 10_000)])
    doc, within = mine.locate(offsets)
    for want_doc, want_within in (ref.locate(offsets),
                                  mine.locate_oracle(offsets),
                                  ref.locate_oracle(offsets)):
        np.testing.assert_array_equal(doc, want_doc)
        np.testing.assert_array_equal(within, want_within)
    assert doc.dtype == np.int64
    assert (within >= 0).all() and (within < lens[doc]).all()


def test_packed_index_refuses_the_cpu_unasked(monkeypatch):
    """Its device defaults to the card; with no card it raises rather
    than build on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        packing.PackedIndex(np.array([8, 9, 10]))


@pytest.mark.parametrize("seq_len", [3, 4, 7])
def test_pack_documents_rows_equal_the_reference(seq_len):
    rng = np.random.default_rng(seq_len)
    docs = [list(rng.integers(2, 100, rng.integers(1, 9))) for _ in range(9)]
    want = list(rpacking.pack_documents(docs, seq_len=seq_len))
    got = list(packing.pack_documents(docs, seq_len=seq_len))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
