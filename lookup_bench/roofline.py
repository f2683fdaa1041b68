"""The yardstick of the kernels' roofline share: the card's published
peaks and the least bytes a batch of lookups has to move.

A lookup needs at least its query read (8 bytes), its answer written
(8 bytes, an int64 rank), and the 32-byte sector of the sorted keys that
holds its answer read once, however many queries of the batch share that
sector (the answer's sector is read by any search that confirms the
rank).  The count depends only on the keys and the queries, so it reads
the same work whatever implements the lookup.
"""
from __future__ import annotations

import torch

#: published peaks by ``torch.cuda.get_device_name()`` (NVIDIA's data
#: sheet, SXM part, at the full 700 W)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}

SECTOR = 32
QUERY_BYTES = 8
ANSWER_BYTES = 8


def answer_sector_bytes(n_keys: int, ranks: torch.Tensor,
                        key_bytes: int = 8) -> int:
    """Bytes of the distinct 32-byte sectors that hold the answers
    (each rank clipped to the array)."""
    unit = SECTOR // key_bytes
    pos = ranks.reshape(-1).clamp(0, n_keys - 1)
    return int(torch.unique(pos // unit).numel()) * SECTOR


def batch_bytes(n_keys: int, ranks: torch.Tensor) -> int:
    """The least bytes one batch of lookups moves: queries read, answers
    written, and the answers' sectors."""
    m = ranks.numel()
    return m * (QUERY_BYTES + ANSWER_BYTES) + answer_sector_bytes(n_keys,
                                                                  ranks)


def least_seconds(total_bytes: float, kind: str):
    """The least time the card could take to move ``total_bytes``, or
    None for a card whose peak the table does not hold."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return total_bytes / peak["hbm_bytes_per_s"]
