"""Int8 gradient compression with error feedback, as the reference's
`repro.dist.compression`.

The cross-pod gradient all-reduce is the one collective that rides the
slow links; the candidate fix is int8 payloads: symmetric linear
quantization, scale = max|g| / 127, with the per-step rounding residual
carried forward and added back before the next quantization (error
feedback / EF-SGD).  This module implements the NUMERICS of that scheme
— what training actually observes — so its convergence cost can be
measured on any backend; the reduce itself runs over the dequantized f32
values (see `compressed_all_reduce` for why, and for what a real int8
transport additionally needs).  The invariants:

  round-trip   dequantize(q) + residual == input (the residual is DEFINED
               as the difference, so this holds to float round-off);
  one-step     |residual| <= scale/2 elementwise (round half to even, as
               `jnp.round` and `torch.round` both round);
  unbiased     with feedback the residual never accumulates, so
               sum_t dequantize(q_t) tracks sum_t g_t to O(scale), not
               O(T * scale).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist


class Compressed(NamedTuple):
    """Int8 payload + f32 scale: the wire format of compressed_all_reduce."""
    q: torch.Tensor        # int8, same shape as the input
    scale: torch.Tensor    # f32 scalar


def quantize(x: torch.Tensor, err: Optional[torch.Tensor] = None
             ) -> Tuple[Compressed, torch.Tensor]:
    """Quantize x (+ carried error) to int8; returns (payload, residual).

    Pass the returned residual back as ``err`` next step for error
    feedback.  scale = max|x + err| / 127 keeps every value inside the
    int8 range, so no clipping ever occurs.
    """
    y = x if err is None else x + err
    y32 = y.float()
    amax = torch.max(torch.abs(y32))
    # tiny floor: an all-zero tensor quantizes to zeros, not NaN
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.round(y32 / scale).to(torch.int8)
    residual = (y32 - q.float() * scale).to(y.dtype)
    return Compressed(q, scale), residual


def dequantize(c: Compressed) -> torch.Tensor:
    return c.q.float() * c.scale


def compressed_all_reduce(x: torch.Tensor, group=None,
                          err: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of the int8-quantized x over ``group``'s ranks (the default
    group when None); returns (sum, residual): thread the residual back
    in as ``err`` on the next step.

    Transport note: this dequantizes BEFORE the all-reduce, so the
    collective itself still moves f32 — it models the numerics of a
    compressed all-reduce (quantization error + error feedback), not the
    wire bytes.  A real int8 transport needs a shared scale (an all-reduce
    of the max first) plus an integer-accumulating reduce, which
    `torch.distributed`'s all_reduce does not offer; wiring that through
    an all-to-all is an open roadmap item.
    """
    c, residual = quantize(x, err)
    total = dequantize(c)
    dist.all_reduce(total, group=group)
    return total, residual
