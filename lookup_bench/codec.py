"""The benchmark's copy of the port's key codec.

The port carries uint64 keys as int64 with the sign bit flipped, an
order-preserving map (``0 -> INT64_MIN``).  The benchmark makes its keys
as non-negative int64 values (every key is below 2^63), hands the program
their flipped form, and keeps the raw form for the reference, so a codec
fault in the program shows as wrong ranks.
"""
from __future__ import annotations

import torch

#: the flipped sign bit, as the int64 value that XOR applies
SIGN = -(1 << 63)


def encode(raw: torch.Tensor) -> torch.Tensor:
    """Raw non-negative int64 keys -> the port's flipped int64 keys."""
    return raw ^ SIGN


def decode(encoded: torch.Tensor) -> torch.Tensor:
    """Inverse of `encode` for keys below 2^63."""
    return encoded ^ SIGN
