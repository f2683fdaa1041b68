"""Sequence packing via learned-index offset lookup, as the reference's
`repro.data.packing`.

Packing N documents into fixed-length training rows needs, for every
token offset in the packed stream, the id of the document that owns it:
``doc = upper_bound(cum_lens, offset) - 1``, the paper's operation over
the cumulative-length array.  `PackedIndex` puts the port's RMI
(`repro_torch.core.rmi`) over the cumulative starts, in the key codec of
`repro_torch.kernels.common` (int64, sign bit flipped); ``locate`` runs
its predict and the bounded binary search on a device, as the reference
runs ``index.lookup`` and ``search.bounded_binary``.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from repro_torch.core import rmi as rmi_mod
from repro_torch.core import search
from repro_torch.kernels.common import encode_keys, resolve_device


class PackedIndex:
    """Offset -> (doc id, within-doc position) via an RMI over cum_lens,
    built and searched on ``device`` (``None``: the CUDA card)."""

    def __init__(self, doc_lens: np.ndarray, branching: int = 1024,
                 device=None):
        self.device = resolve_device(device)
        self.doc_lens = np.asarray(doc_lens, np.int64)
        self.cum = np.concatenate([[0], np.cumsum(self.doc_lens)])
        self.total = int(self.cum[-1])
        # index the cumulative starts (sorted, unique since lens > 0)
        keys = self.cum.astype(np.uint64)
        self.index = rmi_mod.build(keys, branching=branching,
                                   device=self.device)
        self._cum_t = encode_keys(keys, self.device)

    def locate(self, offsets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized: packed offsets -> (doc ids, within-doc positions)."""
        offsets = np.asarray(offsets)
        q = encode_keys(offsets.astype(np.uint64), self.device)
        lo, hi = self.index.lookup(self.index.state, q)
        # LB gives the first cum >= offset; the owner is LB - 1 when
        # cum < offset
        pos = search.bounded_binary(self._cum_t, q, lo, hi,
                                    self.index.meta["max_err"]).cpu().numpy()
        exact = self.cum[np.minimum(pos, len(self.cum) - 1)] == offsets
        doc = np.where(exact, pos, pos - 1).astype(np.int64)
        return doc, offsets - self.cum[doc]

    def locate_oracle(self, offsets: np.ndarray):
        pos = np.searchsorted(self.cum, offsets, side="left")
        exact = self.cum[np.minimum(pos, len(self.cum) - 1)] == offsets
        doc = np.where(exact, pos, pos - 1).astype(np.int64)
        return doc, offsets - self.cum[doc]


def pack_documents(doc_tokens, seq_len: int, pad_id: int = 0,
                   eod_id: int = 1) -> Iterator[np.ndarray]:
    """Greedy-concatenate documents into fixed rows with EOD separators."""
    buf: list = []
    for doc in doc_tokens:
        buf.extend(list(doc))
        buf.append(eod_id)
        while len(buf) >= seq_len:
            yield np.asarray(buf[:seq_len], np.int32)
            buf = buf[seq_len:]
    if buf:
        row = buf + [pad_id] * (seq_len - len(buf))
        yield np.asarray(row, np.int32)
