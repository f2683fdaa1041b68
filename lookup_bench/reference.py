"""The plain reference that decides ``correct``, and its control.

The reference is the definition of the answer: the lower-bound rank of
each query, ``#keys < q``, by `torch.searchsorted` over the raw keys the
benchmark made.  It imports nothing of the port and reads nothing the
port made.  The control is the same search with keys and queries rounded
to float32, which breaks the guarantee every configuration states (the
exact rank); a comparison that the control passes cannot tell a correct
program from a wrong one.
"""
from __future__ import annotations

import torch

#: queries a reference call searches at once
BLOCK = 1 << 22


def lower_bound(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """int64 ``#keys < q`` for each query, over sorted int64 ``keys``."""
    flat = queries.reshape(-1)
    out = torch.empty(flat.shape[0], dtype=torch.int64, device=flat.device)
    for i in range(0, flat.shape[0], BLOCK):
        out[i:i + BLOCK] = torch.searchsorted(keys, flat[i:i + BLOCK],
                                              side="left")
    return out.reshape(queries.shape)


def lower_bound_f32(keys: torch.Tensor, queries: torch.Tensor
                    ) -> torch.Tensor:
    """The control: `lower_bound` with keys and queries rounded to f32."""
    k32 = keys.to(torch.float32)
    flat = queries.reshape(-1)
    out = torch.empty(flat.shape[0], dtype=torch.int64, device=flat.device)
    for i in range(0, flat.shape[0], BLOCK):
        out[i:i + BLOCK] = torch.searchsorted(
            k32, flat[i:i + BLOCK].to(torch.float32), side="left")
    return out.reshape(queries.shape)


def wrong_ranks(got: torch.Tensor, want: torch.Tensor) -> int:
    """Answers that differ from the reference's, a lane missing or of
    another shape counting as wrong."""
    got = got.reshape(-1)
    want = want.reshape(-1)
    m = min(got.shape[0], want.shape[0])
    missing = abs(got.shape[0] - want.shape[0])
    return int((got[:m].to(torch.int64) != want[:m]).sum()) + missing
