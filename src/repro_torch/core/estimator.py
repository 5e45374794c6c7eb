"""Progressive distance estimation with level-wise pruning (FaTRQ §III/§IV).

Each level scores a whole candidate batch, computes the top-k threshold τ
(kth-smallest certified upper bound among survivors) and keeps a candidate
only while its certified lower bound is ≤ τ.  Bounds:

* ``cauchy`` (provable, needs per-record rho): the error of −2⟨q,δ⟩'s
  estimate is at most ``2·||q||·||δ||·√(1−⟨e_q,e_c⟩²)·√(1−rho²)``.
* ``quantile``: margin ``z · resid_std`` from the calibration model.

Unlike the JAX module (single query, vmapped by its callers) every function
here takes leading batch dimensions: ``q (..., D)``, candidates
``(..., C)`` and codes ``(..., C, D)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import calibration as calib
from repro_torch.core.decomposition import RecordScalars
from repro_torch.core.ternary import ternary_inner


@dataclass(frozen=True)
class ProgressiveState:
    """State after one refinement level."""

    est: torch.Tensor     # (..., C) calibrated estimate
    lo: torch.Tensor      # (..., C) certified lower bound
    alive: torch.Tensor   # (..., C) bool
    tau: torch.Tensor     # (...,) pruning threshold


def _unit(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    qn = torch.linalg.vector_norm(q, dim=-1)
    return qn, q / torch.clamp(qn, min=1e-30)[..., None]


def residual_ip_estimate(q: torch.Tensor, codes: torch.Tensor,
                         norms: torch.Tensor,
                         rho: torch.Tensor | None = None) -> torch.Tensor:
    """Estimate −2⟨q, δ⟩ = −2·||q||·||δ||·⟨e_q, e_code⟩·rho.
    q (..., D), codes (..., C, D) int8, norms/rho (..., C)."""
    qn, e_q = _unit(q)
    align = ternary_inner(codes, e_q[..., None, :])
    scale = rho if rho is not None else 1.0
    return -2.0 * qn[..., None] * norms * align * scale


def cauchy_margin(q: torch.Tensor, codes: torch.Tensor, norms: torch.Tensor,
                  rho: torch.Tensor) -> torch.Tensor:
    """Provable half-width of −2⟨q,δ⟩ around its estimate."""
    qn, e_q = _unit(q)
    align = ternary_inner(codes, e_q[..., None, :])
    orth_q = torch.sqrt(torch.clamp(1.0 - align * align, 0.0, 1.0))
    orth_d = torch.sqrt(torch.clamp(1.0 - rho * rho, 0.0, 1.0))
    return 2.0 * qn[..., None] * norms * orth_q * orth_d


def pooled_k_smallest(values: torch.Tensor, k: int,
                      shard_dim: int | None = None,
                      mesh=None) -> torch.Tensor:
    """kth-smallest value along the last axis (+inf encodes masked entries).
    Only the value is returned, so ``topk``'s tie order does not matter.

    With ``shard_dim`` (a non-negative dimension of ``values`` stacking
    the shards this process holds) each shard contributes its
    ``min(k, C_s)`` smallest, the pools are concatenated in shard order
    and the kth smallest of the pool is the exact global kth smallest: any
    global top-k member is in its shard's local top-k.  With a ``mesh``
    (``launch.mesh.SearchMesh``) the pools of the mesh's ranks are
    all-gathered in rank order first, so every rank takes the kth
    smallest of the same pool: the stacked form's value, bit for bit.
    The result drops ``shard_dim`` and the last axis."""
    if shard_dim is not None:
        kk = min(k, values.shape[-1])
        local = torch.topk(values, kk, dim=-1, largest=False).values
        if mesh is not None:
            local = mesh.all_gather(local, shard_dim)
        values = local.movedim(shard_dim, -2).flatten(-2)
    kk = min(k, values.shape[-1])
    return torch.topk(values, kk, dim=-1, largest=False).values[..., -1]


def topk_threshold(estimates: torch.Tensor, alive: torch.Tensor, k: int,
                   shard_dim: int | None = None,
                   mesh=None) -> torch.Tensor:
    """kth-smallest upper estimate among alive candidates (τ), pooled
    across ``shard_dim`` (and the ``mesh``) when it is given (see
    ``pooled_k_smallest``)."""
    masked = torch.where(alive, estimates,
                         torch.full_like(estimates, float("inf")))
    return pooled_k_smallest(masked, k, shard_dim, mesh)


def alive_chain(lo: torch.Tensor, hi: torch.Tensor, alive: torch.Tensor,
                k: int, shard_dim: int | None = None, mesh=None
                ) -> tuple[tuple[torch.Tensor, ...], tuple[torch.Tensor, ...]]:
    """Level-wise pruning over precomputed certified intervals.

    lo/hi (..., L, C), alive (..., C) the starting mask.  Per level
    τ = kth-smallest ``hi`` among the alive (pooled across ``shard_dim``
    and the ``mesh`` when given), then ``alive &= lo ≤ τ``.  Returns the
    alive mask and τ after every level."""
    alives, taus = [], []
    for lv in range(lo.shape[-2]):
        tau = topk_threshold(hi[..., lv, :], alive, k, shard_dim, mesh)
        wide = tau[..., None] if shard_dim is None \
            else tau.unsqueeze(shard_dim)[..., None]
        alive = alive & (lo[..., lv, :] <= wide)
        alives.append(alive)
        taus.append(tau)
    return tuple(alives), tuple(taus)


def level0_bounds(q: torch.Tensor, d0: torch.Tensor, scalars: RecordScalars,
                  codes: torch.Tensor, model: calib.CalibrationModel, *,
                  bound: str = "cauchy", z: float = 3.0
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Level 0's calibrated estimate and certified (lo, hi), unpruned."""
    d_ip = residual_ip_estimate(q, codes, scalars.norm, scalars.rho)
    feats = calib.build_features(d0, d_ip, scalars.delta_sq, scalars.cross)
    est = calib.predict(model, feats)
    if bound == "cauchy":
        # certified interval around the uncalibrated decomposition identity
        est_raw = d0 + scalars.delta_sq + 2.0 * scalars.cross + d_ip
        margin = cauchy_margin(q, codes, scalars.norm, scalars.rho)
        return est, est_raw - margin, est_raw + margin
    if bound == "quantile":
        margin = z * model.resid_std
        return est, est - margin, est + margin
    raise ValueError(f"unknown bound {bound!r}")


def refine_level(q: torch.Tensor, d0: torch.Tensor, scalars: RecordScalars,
                 codes: torch.Tensor, model: calib.CalibrationModel, *,
                 k: int, bound: str = "cauchy", z: float = 3.0,
                 prev_alive: torch.Tensor | None = None) -> ProgressiveState:
    """One FaTRQ refinement level over a candidate batch."""
    if prev_alive is None:
        prev_alive = torch.ones_like(d0, dtype=torch.bool)
    est, lo, hi = level0_bounds(q, d0, scalars, codes, model, bound=bound,
                                z=z)
    tau = topk_threshold(hi, prev_alive, k)
    alive = prev_alive & (lo <= tau[..., None])
    return ProgressiveState(est=est, lo=lo, alive=alive, tau=tau)


def refine_batch(q: torch.Tensor, d0: torch.Tensor, scalars: RecordScalars,
                 codes: torch.Tensor, model: calib.CalibrationModel, *,
                 k: int, bound: str = "cauchy", z: float = 3.0
                 ) -> ProgressiveState:
    """One refinement level from every candidate alive (the paper's
    second-order operating point); the multi-level stack is
    ``trq.progressive_search``."""
    return refine_level(q, d0, scalars, codes, model, k=k, bound=bound, z=z)
