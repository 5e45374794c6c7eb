"""L2 distance decomposition (FaTRQ §III-A).

    ||x - q||² = ||q - x_c||² + ||δ||² + 2⟨x_c, δ⟩ − 2⟨q, δ⟩ ,   δ = x − x_c

``||δ||²`` and ``⟨x_c, δ⟩`` are per-record scalars precomputed offline.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class RecordScalars:
    """Per-record metadata: the paper's 8 bytes plus rho and ||δ||."""

    delta_sq: torch.Tensor     # ||δ||²
    cross: torch.Tensor        # ⟨x_c, δ⟩
    rho: torch.Tensor          # ⟨e_δ, e_code⟩ (provable Cauchy bound)
    norm: torch.Tensor         # ||δ||

    def take(self, idx: torch.Tensor) -> "RecordScalars":
        """Rows ``idx`` of every field."""
        return RecordScalars(delta_sq=self.delta_sq[idx],
                             cross=self.cross[idx], rho=self.rho[idx],
                             norm=self.norm[idx])


def compute_scalars(x: torch.Tensor, x_c: torch.Tensor,
                    rho: torch.Tensor | None = None) -> RecordScalars:
    """Per-record scalars from the vectors and their coarse reconstruction."""
    delta = x - x_c
    delta_sq = (delta * delta).sum(-1)
    cross = (x_c * delta).sum(-1)
    norm = torch.sqrt(delta_sq)
    if rho is None:
        rho = torch.zeros_like(norm)
    return RecordScalars(delta_sq=delta_sq.float(), cross=cross.float(),
                         rho=rho.float(), norm=norm.float())


def exact_distance_sq(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """||x − q||² on the trailing axis (ground truth, the final rerank)."""
    diff = x - q
    return (diff * diff).sum(-1)


def first_order(d0: torch.Tensor, scalars: RecordScalars) -> torch.Tensor:
    """d̂₁ = d̂₀ + ||δ||² + 2⟨x_c,δ⟩: no query-time I/O beyond the
    scalars (the precomputed cross term is free and tighter than the
    paper's first d̂₀ + ||δ||²)."""
    return d0 + scalars.delta_sq + 2.0 * scalars.cross


def decomposed_distance_sq(d0: torch.Tensor, scalars: RecordScalars,
                           q_dot_delta: torch.Tensor) -> torch.Tensor:
    """The exact identity given the true ⟨q, δ⟩."""
    return d0 + scalars.delta_sq + 2.0 * scalars.cross - 2.0 * q_dot_delta
