"""Plain oracle for the bounded last-mile search."""
from __future__ import annotations

import torch


def lower_bound_windows_ref(data, queries, lo, max_width: int):
    """LB(q) for each query, given windows [lo, lo+max_width) known to
    contain it.  The oracle ignores the windows and searches the whole
    (encoded) array; the kernel must agree wherever the window
    precondition holds."""
    del lo, max_width
    return torch.searchsorted(data, queries, side="left").to(torch.int32)
