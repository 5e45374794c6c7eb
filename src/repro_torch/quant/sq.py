"""Scalar-quantization baselines (§V-C comparisons), the port of
``repro.quant.sq``.

* int8 whole-vector SQ (the "w/o RQ" baseline in Fig. 7);
* b-bit residual SQ (the BANG-style residual scheme [12]): a per-record
  min/max range and uniform levels, used at 3 and 4 bits in the paper.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SQCode(NamedTuple):
    codes: torch.Tensor   # (N, D) uint8
    lo: torch.Tensor      # (N,) per-record min
    step: torch.Tensor    # (N,) per-record step


def sq_encode(x: torch.Tensor, bits: int) -> SQCode:
    """Uniform per-record scalar quantization to 2^bits levels."""
    levels = (1 << bits) - 1
    lo = x.amin(-1)
    hi = x.amax(-1)
    step = torch.clamp(hi - lo, min=1e-12) / levels
    q = torch.clamp(torch.round((x - lo[..., None]) / step[..., None]), 0,
                    levels)
    return SQCode(codes=q.to(torch.uint8), lo=lo.float(), step=step.float())


def sq_decode(code: SQCode) -> torch.Tensor:
    return code.codes.float() * code.step[..., None] + code.lo[..., None]


def sq_bytes_per_record(d: int, bits: int, *, n_scalars: int = 2) -> int:
    """Storage: ceil(D·bits/8) + the range scalars."""
    return -(-d * bits // 8) + 4 * n_scalars


def int8_encode(x: torch.Tensor) -> SQCode:
    """Whole-vector int8 (the paper's "INT8 w/o RQ" line)."""
    return sq_encode(x, 8)
