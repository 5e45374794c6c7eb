"""Tiered Residual Quantization: the database's far-memory encoding.

Records are encoded against their coarse (PQ) reconstructions into L
stacked ternary levels plus per-record scalars; level ℓ encodes what is
left after projecting out level ℓ−1's approximation.  ``progressive_search``
is the plain PyTorch refinement (the ``reference`` backend) and
``level_bounds`` its unpruned intervals (the sharded layout pools its
thresholds across shards); the ``cuda`` backend runs the same math in
``kernels.ternary_refine``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import calibration as calib
from repro_torch.core import packing
from repro_torch.core.decomposition import RecordScalars, compute_scalars
from repro_torch.core.estimator import (ProgressiveState, alive_chain,
                                        level0_bounds, residual_ip_estimate)
from repro_torch.core.ternary import reconstruct, ternary_encode, \
    ternary_inner
from repro_torch.device import chunks

#: rows per encoding step: every per-record quantity is row-independent,
#: so encoding in chunks only bounds the sort/unpack working set
ENCODE_ROWS = 1 << 16


@dataclass(frozen=True)
class TRQLevel:
    """One far-memory level: packed codes + per-level scalars."""

    packed: torch.Tensor    # (N, ceil(D/5)) uint8
    proj: torch.Tensor      # (N,) ⟨δ_ℓ, e_code⟩ = ||δ_ℓ||·rho_ℓ
    norm: torch.Tensor      # (N,) ||δ_ℓ||
    rho: torch.Tensor       # (N,) ⟨e_δℓ, e_code⟩


@dataclass(frozen=True)
class TRQCodes:
    """Full FaTRQ encoding of a database."""

    dim: int
    levels: tuple[TRQLevel, ...]
    scalars: RecordScalars
    model: calib.CalibrationModel

    @property
    def num_levels(self) -> int:
        return len(self.levels)


def _encode_rows(x: torch.Tensor, x_c: torch.Tensor, num_levels: int):
    resid = x - x_c
    levels = []
    rho0 = None
    for _ in range(num_levels):
        tc = ternary_encode(resid)
        rho0 = tc.rho if rho0 is None else rho0
        levels.append((packing.pack_ternary(tc.code), tc.norm * tc.rho,
                       tc.norm, tc.rho))
        resid = resid - reconstruct(tc)
    return levels, compute_scalars(x, x_c, rho=rho0)


def encode_database(x: torch.Tensor, x_c: torch.Tensor, *,
                    num_levels: int = 1) -> TRQCodes:
    """Encode records ``x (N, D)`` against coarse reconstructions ``x_c``
    (identity calibration model: call ``calibrate`` to fit)."""
    parts = [_encode_rows(x[a:b], x_c[a:b], num_levels)
             for a, b in chunks(x.shape[0], ENCODE_ROWS)]
    levels = tuple(
        TRQLevel(*(torch.cat([p[0][lv][i] for p in parts]) for i in range(4)))
        for lv in range(num_levels))
    scalars = RecordScalars(*(torch.cat([getattr(p[1], f) for p in parts])
                              for f in ("delta_sq", "cross", "rho", "norm")))
    return TRQCodes(dim=x.shape[-1], levels=levels, scalars=scalars,
                    model=calib.identity_model(x.device))


def encode_rows(x_new: torch.Tensor, x_c_new: torch.Tensor, *,
                num_levels: int = 1,
                model: calib.CalibrationModel | None = None) -> TRQCodes:
    """TRQ codes of new rows ``x_new (B, D)`` only.  Every per-record
    quantity is row-independent, so these are the rows a full
    ``encode_database`` of the grown database would give them; ``model``
    carries the fitted calibration over (identity if None)."""
    codes = encode_database(x_new, x_c_new, num_levels=num_levels)
    if model is None:
        return codes
    return TRQCodes(dim=codes.dim, levels=codes.levels,
                    scalars=codes.scalars, model=model)


def _per_record(codes: TRQCodes) -> list[torch.Tensor]:
    """Every per-record tensor of ``codes``, in one fixed order."""
    sc = codes.scalars
    return [t for lv in codes.levels for t in (lv.packed, lv.proj, lv.norm,
                                               lv.rho)] + \
        [sc.delta_sq, sc.cross, sc.rho, sc.norm]


def write_rows(dst: TRQCodes, src: TRQCodes, start: int) -> TRQCodes:
    """Write ``src``'s rows into ``dst`` at rows ``start…``; returns
    ``dst`` (its dim and calibration model stay).

    The JAX package's ``write_rows`` is a functional update; this one
    writes ``dst``'s tensors in place, so ``dst`` must own them (the
    streaming row store does: it never shares its capacity-padded tensors
    with an index or snapshot) and hold at least start + len(src) rows.
    """
    if dst.num_levels != src.num_levels or dst.dim != src.dim:
        raise ValueError("write_rows: level/dim mismatch between dst and src")
    for d, s in zip(_per_record(dst), _per_record(src)):
        d[start:start + s.shape[0]] = s
    return dst


def gather_rows(codes: TRQCodes, idx: torch.Tensor) -> TRQCodes:
    """Every per-record tensor gathered at rows ``idx`` (new tensors); dim
    and calibration model pass through.  Codes are centroid-relative, so a
    moved row needs no re-encode."""
    return map_rows(codes, lambda t: t[idx])


def map_rows(codes: TRQCodes, fn) -> TRQCodes:
    """``codes`` with ``fn`` applied to every per-record tensor."""
    return TRQCodes(
        dim=codes.dim,
        levels=tuple(TRQLevel(*map(fn, (lv.packed, lv.proj, lv.norm,
                                        lv.rho))) for lv in codes.levels),
        scalars=RecordScalars(*map(fn, (codes.scalars.delta_sq,
                                        codes.scalars.cross,
                                        codes.scalars.rho,
                                        codes.scalars.norm))),
        model=codes.model)


def unpack_level(codes: TRQCodes, level: int,
                 idx: torch.Tensor | None = None) -> torch.Tensor:
    """int8 trits for (a subset of) records at one level."""
    packed = codes.levels[level].packed
    if idx is not None:
        packed = packed[idx]
    return packing.unpack_ternary(packed, codes.dim)


def estimate_q_dot_delta(q: torch.Tensor, codes: TRQCodes,
                         idx: torch.Tensor | None = None, *,
                         through_level: int | None = None) -> torch.Tensor:
    """Σ_ℓ ⟨δ_ℓ, e_cℓ⟩·⟨q, e_cℓ⟩, the stacked estimate of ⟨q, δ⟩ over the
    first ``through_level`` levels (every level unless given), for the
    records ``idx`` (every record unless given); exact as L → D."""
    through = codes.num_levels if through_level is None else through_level
    total = 0.0
    for lv in range(through):
        proj = codes.levels[lv].proj
        align = ternary_inner(unpack_level(codes, lv, idx), q)
        total = total + (proj if idx is None else proj[idx]) * align
    return total


def calibrate(codes: TRQCodes, q_samples: torch.Tensor, x: torch.Tensor,
              x_c: torch.Tensor, pair_idx: torch.Tensor) -> TRQCodes:
    """Fit the OLS calibration model on (query, record) pairs: row p of
    ``q_samples (P, D)`` is paired with database row ``pair_idx[p]``."""
    xi, xci = x[pair_idx], x_c[pair_idx]
    d0 = ((q_samples - xci) ** 2).sum(-1)
    true_d = ((q_samples - xi) ** 2).sum(-1)
    sc = codes.scalars.take(pair_idx)
    trits = unpack_level(codes, 0, pair_idx)
    d_ip = residual_ip_estimate(q_samples, trits[:, None],
                                sc.norm[:, None], sc.rho[:, None])[:, 0]
    feats = calib.build_features(d0, d_ip, sc.delta_sq, sc.cross)
    return TRQCodes(dim=codes.dim, levels=codes.levels, scalars=codes.scalars,
                    model=calib.fit(feats, true_d))


def level_bounds(q: torch.Tensor, d0: torch.Tensor, codes: TRQCodes,
                 cand_idx: torch.Tensor, *, bound: str = "cauchy",
                 z: float = 3.0
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every TRQ level's estimate and certified interval, with no pruning
    (nothing depends across levels but each candidate's running estimate).
    q (Q, D), d0 and cand_idx (Q, C) → (est (Q, C) after the last level,
    lo (Q, L, C), hi (Q, L, C))."""
    est, lo, hi = level0_bounds(q, d0, codes.scalars.take(cand_idx),
                                unpack_level(codes, 0, cand_idx), codes.model,
                                bound=bound, z=z)
    los, his = [lo], [hi]
    qn = torch.linalg.vector_norm(q, dim=-1)[..., None]
    for lv in range(1, codes.num_levels):
        level = codes.levels[lv]
        align = ternary_inner(unpack_level(codes, lv, cand_idx),
                              q[..., None, :])
        est = est - 2.0 * level.proj[cand_idx] * align
        rho = level.rho[cand_idx]
        rem = level.norm[cand_idx] * torch.sqrt(
            torch.clamp(1.0 - rho ** 2, 0.0, 1.0))
        margin = 2.0 * qn * rem + codes.model.resid_std
        los.append(est - margin)
        his.append(est + margin)
    return est, torch.stack(los, dim=-2), torch.stack(his, dim=-2)


def progressive_search(q: torch.Tensor, d0: torch.Tensor, codes: TRQCodes,
                       cand_idx: torch.Tensor, *, k: int,
                       bound: str = "cauchy", z: float = 3.0
                       ) -> tuple[ProgressiveState, tuple[torch.Tensor, ...]]:
    """All TRQ levels over per-query candidate lists, pruning between
    levels.  q (Q, D), d0 and cand_idx (Q, C).  Returns the final state and
    the alive mask after every level (level ℓ+1's far-memory traffic is
    billed to level ℓ's survivors)."""
    est, lo, hi = level_bounds(q, d0, codes, cand_idx, bound=bound, z=z)
    level_alive, taus = alive_chain(
        lo, hi, torch.ones_like(d0, dtype=torch.bool), k)
    state = ProgressiveState(est=est, lo=lo[..., -1, :],
                             alive=level_alive[-1], tau=taus[-1])
    return state, level_alive
