"""Paged KV cache bookkeeping with a learned-index slot table.

The reference's `repro.serve.kv_cache`: the cache is a pool of fixed-size
pages and each sequence owns a scattered page list (vLLM's layout).  Two
sorted-array lookups are on the hot path, both the paper's operation:

  1. flat slot -> request id: continuous batching packs every live token
     into one flat buffer, whose request boundaries are the cumulative
     lengths, so the map is ``upper_bound(cum_lens, slot) - 1``.  It is
     served by a linear model with a verified error and a fixup window
     searched by the bounded last-mile kernel (B1, on int32 keys).
  2. logical page -> physical page: a gather through the block table.

Allocation is host numpy, as in the reference; the slot lookup runs on
the slots' device: B1 on the card, its plain version on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.kernels.bounded_search.ops import lower_bound_windows


@dataclasses.dataclass
class PageAllocator:
    """Host-side page pool: O(1) alloc/free via a free list."""

    n_pages: int
    page_size: int

    def __post_init__(self):
        self.free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self.owner: Dict[int, int] = {}

    def alloc(self, seq_id: int, n: int = 1) -> List[int]:
        if len(self.free) < n:
            raise MemoryError(f"KV pool exhausted ({n} pages requested, "
                              f"{len(self.free)} free)")
        pages = [self.free.pop() for _ in range(n)]
        for p in pages:
            self.owner[p] = seq_id
        return pages

    def release(self, pages: List[int]):
        for p in pages:
            self.owner.pop(p, None)
            self.free.append(p)

    @property
    def utilization(self) -> float:
        return 1.0 - len(self.free) / self.n_pages


class LearnedSlotIndex:
    """flat token slot -> request id via a learned linear CDF model.

    Build: the slope over (cum_lens, request ids) and its worst error at
    the boundaries, verified (as the RMI's error tables are).  Lookup:
    predict, then the exact upper bound inside the fixup window.
    """

    def __init__(self, cum_lens: np.ndarray):
        # cum_lens[i] = first flat slot of request i; last entry = total.
        self.cum = np.asarray(cum_lens, np.int64)
        if len(self.cum) and int(self.cum[-1]) >= 2 ** 31:
            raise ValueError(f"{int(self.cum[-1])} live tokens: the int32 "
                             "slot index needs fewer than 2^31")
        n_req = len(self.cum) - 1
        total = max(int(self.cum[-1]), 1)
        self.slope = n_req / total
        pred = self.cum[:-1] * self.slope
        self.err = int(np.ceil(np.abs(pred - np.arange(n_req)).max())) + 1 \
            if n_req else 1
        self.n_req = n_req

    def lookup(self, slots: torch.Tensor) -> torch.Tensor:
        """int32 slots [m] -> int32 request ids, on the slots' device.

        The reference's arithmetic step for step: the float32 product with
        the float32 slope, truncated to int32, ``lo = clip(pred - err, 0,
        n_req)``, then B1 for ``slots + 1`` in ``cum`` over windows of
        ``2 * err + 2``, and ``clip(ub - 1, 0, n_req - 1)``."""
        slope = torch.tensor(np.float32(self.slope), device=slots.device)
        pred = slots.to(torch.float32) * slope
        lo = torch.clamp(pred.to(torch.int32) - self.err, 0, self.n_req)
        cum = torch.from_numpy(self.cum.astype(np.int32)).to(slots.device)
        ub = lower_bound_windows(cum, slots.to(torch.int32) + 1, lo,
                                 max_width=2 * self.err + 2)
        return torch.clamp(ub - 1, 0, self.n_req - 1)


class PagedKVCache:
    """Block-table bookkeeping for one layer stack.

    Physical store: ``[n_pages, page_size, n_kv, hd]`` per k/v per layer;
    this class keeps the table and the allocator.  ``gather_spec`` gives
    the int32 indices a decode step needs to address scattered pages as
    if they were contiguous.
    """

    def __init__(self, n_pages: int, page_size: int, max_seqs: int,
                 max_pages_per_seq: int):
        self.alloc = PageAllocator(n_pages, page_size)
        self.page_size = page_size
        self.table = np.full((max_seqs, max_pages_per_seq), -1, np.int32)
        self.lens = np.zeros((max_seqs,), np.int32)
        self.pages: Dict[int, List[int]] = {}

    def add_sequence(self, seq_id: int, n_tokens: int):
        n_pages = -(-n_tokens // self.page_size)
        pages = self.alloc.alloc(seq_id, n_pages)
        self.pages[seq_id] = pages
        self.table[seq_id, :n_pages] = pages
        self.lens[seq_id] = n_tokens

    def append_token(self, seq_id: int):
        n = int(self.lens[seq_id])
        if n % self.page_size == 0:  # page boundary: grow
            new = self.alloc.alloc(seq_id, 1)[0]
            self.pages[seq_id].append(new)
            self.table[seq_id, n // self.page_size] = new
        self.lens[seq_id] = n + 1

    def free_sequence(self, seq_id: int):
        self.alloc.release(self.pages.pop(seq_id, []))
        self.table[seq_id] = -1
        self.lens[seq_id] = 0

    def gather_spec(self, seq_ids: np.ndarray):
        """For each seq: physical slot of every logical position.

        Returns int32 [len(seq_ids), max_len] flat indices into the page
        pool (page * page_size + offset), -1 past each length."""
        max_len = int(self.lens[seq_ids].max()) if len(seq_ids) else 0
        out = np.full((len(seq_ids), max(max_len, 1)), -1, np.int32)
        for r, sid in enumerate(seq_ids):
            n = int(self.lens[sid])
            logical = np.arange(n)
            phys_page = self.table[sid, logical // self.page_size]
            out[r, :n] = phys_page * self.page_size + logical % self.page_size
        return out

    def slot_index(self) -> LearnedSlotIndex:
        live = np.flatnonzero(self.lens > 0)
        cum = np.concatenate([[0], np.cumsum(self.lens[live])])
        return LearnedSlotIndex(cum)
