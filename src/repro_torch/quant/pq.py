"""Product quantization (Jégou et al.): FaTRQ's coarse quantizer.

A D-dim vector splits into M subspaces of D/M dims, each with its own
K-entry codebook (K=256 → 1 byte per subspace).  ADC builds a per-query
(M, K) table of partial squared distances; scoring a code is M lookups.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import chunks
from repro_torch.quant.kmeans import assign_batched, kmeans_batched

#: rows per encode step (bounds the transposed subspace copy)
_ENCODE_ROWS = 1 << 18


@dataclass(frozen=True)
class PQCodebook:
    codebooks: torch.Tensor   # (M, K, Ds)

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def k(self) -> int:
        return self.codebooks.shape[1]

    @property
    def ds(self) -> int:
        return self.codebooks.shape[2]


def _subspaces(x: torch.Tensor, m: int) -> torch.Tensor:
    n, d = x.shape
    return x.reshape(n, m, d // m).transpose(0, 1).contiguous()  # (M, N, Ds)


def train(x: torch.Tensor, m: int, k: int = 256, iters: int = 20, *,
          init_idx: torch.Tensor) -> PQCodebook:
    """Train M sub-codebooks on x (N, D); ``init_idx`` (M, k) holds each
    subspace's initial rows (the JAX build draws one key per subspace)."""
    d = x.shape[1]
    if d % m:
        raise ValueError(f"D={d} not divisible by M={m}")
    return PQCodebook(codebooks=kmeans_batched(_subspaces(x, m), k, iters,
                                               init_idx))


def encode(cb: PQCodebook, x: torch.Tensor) -> torch.Tensor:
    """x (N, D) → codes (N, M) uint8."""
    out = torch.empty((x.shape[0], cb.m), dtype=torch.uint8, device=x.device)
    for a, b in chunks(x.shape[0], _ENCODE_ROWS):
        out[a:b] = assign_batched(_subspaces(x[a:b], cb.m), cb.codebooks).T
    return out


def decode(cb: PQCodebook, codes: torch.Tensor) -> torch.Tensor:
    """codes (N, M) → reconstruction x_c (N, D)."""
    sub = torch.arange(cb.m, device=codes.device)
    return cb.codebooks[sub, codes.long()].reshape(codes.shape[0], -1)


def adc_table(cb: PQCodebook, q: torch.Tensor) -> torch.Tensor:
    """Per-query LUTs (Q, M, K) of partial ``Σ (q_m − c_mk)²`` for q (Q, D);
    the difference form the JAX package uses (not ||q||² − 2q·c + ||c||²),
    so tables agree to within the rounding of the Ds-term sum."""
    qs = q.reshape(q.shape[0], cb.m, 1, cb.ds)
    diff = qs - cb.codebooks[None]
    return (diff * diff).sum(-1)


def adc_distances(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Score codes (..., N, M) against LUTs (..., M, K) → (..., N)."""
    idx = codes.long().transpose(-1, -2)                      # (..., M, N)
    return torch.gather(table, -1, idx).sum(-2)


def reconstruction_error(cb: PQCodebook, x: torch.Tensor) -> torch.Tensor:
    """Mean squared L2 error of x (N, D) through encode and decode, 0-d."""
    return ((x - decode(cb, encode(cb, x))) ** 2).sum(-1).mean()
