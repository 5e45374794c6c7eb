"""Base-3 packing of ternary codes: 5 trits per byte (FaTRQ §III-D).

``y = Σ_{i=0..4} 3^i (x_i + 1)`` maps 5 values in {-1,0,1} to one byte in
[0, 242]; digit i of byte g holds dimension 5g+i.  768-D → 154 bytes.
Trailing-axis semantics; bit-exact with the JAX package's packing.
"""

from __future__ import annotations

import torch

TRITS_PER_BYTE = 5
POW3 = (1, 3, 9, 27, 81)


def packed_size(d: int) -> int:
    """Bytes needed for a D-dimensional ternary code."""
    return -(-d // TRITS_PER_BYTE)


def pack_ternary(code: torch.Tensor) -> torch.Tensor:
    """Pack int8 trits in {-1,0,1} ``(..., D)`` → uint8 ``(..., ceil(D/5))``.
    Padding trits are 0 (digit 1), harmless on unpack+truncate."""
    d = code.shape[-1]
    g = packed_size(d)
    pad = g * TRITS_PER_BYTE - d
    digits = code.to(torch.int32) + 1
    if pad:
        digits = torch.nn.functional.pad(digits, (0, pad), value=1)
    digits = digits.reshape(*code.shape[:-1], g, TRITS_PER_BYTE)
    weights = torch.tensor(POW3, dtype=torch.int32, device=code.device)
    return (digits * weights).sum(-1).to(torch.uint8)


def unpack_ternary(packed: torch.Tensor, d: int) -> torch.Tensor:
    """Unpack uint8 ``(..., G)`` → int8 trits ``(..., D)`` in {-1,0,1}."""
    y = packed.to(torch.int32)[..., None]
    weights = torch.tensor(POW3, dtype=torch.int32, device=packed.device)
    digits = torch.div(y, weights, rounding_mode="floor") % 3
    trits = digits.reshape(*packed.shape[:-1],
                           packed.shape[-1] * TRITS_PER_BYTE)
    return (trits[..., :d] - 1).to(torch.int8)


def storage_bytes(d: int, *, n_scalars: int = 2, scalar_bytes: int = 4
                  ) -> int:
    """Per-record far-memory footprint (the paper: 768 → 154 + 8 = 162
    B)."""
    return packed_size(d) + n_scalars * scalar_bytes
