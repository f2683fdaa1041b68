"""Deterministic sharded token pipeline for the train driver, as the
reference's `repro.data.pipeline`: the same batches, bit for bit.

A synthetic corpus with the production-shaped surface: seeded document
lengths, per-host sharding, packed fixed-length rows and a resumable
cursor (a step's rows are a pure function of (seed, step, host), so a
restored checkpoint resumes the stream exactly).  The tokens are a
uint64 hash stream computed with numpy on the host; the batches are
numpy, moved to a device by the caller.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.data.packing import PackedIndex


@dataclasses.dataclass
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_docs: int = 4096
    mean_doc_len: int = 512
    host_id: int = 0
    n_hosts: int = 1


class TokenPipeline:
    """``device`` is where the packed index is built (``None``: the CUDA
    card); the batches themselves are host arrays."""

    def __init__(self, cfg: PipelineConfig, device=None):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.doc_lens = np.maximum(
            rng.geometric(1.0 / cfg.mean_doc_len, cfg.n_docs), 8)
        self.packed = PackedIndex(self.doc_lens, device=device)
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def _tokens_at(self, offsets: np.ndarray) -> np.ndarray:
        """Content-addressed synthetic tokens: doc-seeded hash stream."""
        doc, within = self.packed.locate_oracle(offsets % self.packed.total)
        h = (doc.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
             + within.astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9))
        return ((h >> np.uint64(33)) % np.uint64(self.cfg.vocab - 2) + 2
                ).astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, host): resumable by construction."""
        c = self.cfg
        base = step * c.global_batch + c.host_id * self.local_batch
        rows = np.arange(self.local_batch) + base
        offsets = (rows[:, None] * c.seq_len
                   + np.arange(c.seq_len + 1)[None, :])
        toks = self._tokens_at(offsets.reshape(-1)).reshape(
            self.local_batch, c.seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
