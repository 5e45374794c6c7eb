"""Input assembly for the kernels, the shared-memory budget check and the
level-0 scoring entry points.

The refine kernels read a query as 5 digit planes of (G,) floats (byte g's
digit i holds dim 5g+i), one parameter row per query, and per-record
scalars gathered by candidate id from (N, 4) tables built once per index.
``refine_scores_batch`` / ``refine_scores`` keep the JAX package's
signatures (``repro.kernels.ops``): they assemble those inputs from
per-candidate arrays and run the level-0 kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core.packing import TRITS_PER_BYTE
from repro_torch.kernels import ternary_refine as _kernels

#: shared memory one block may use on Hopper (227 KB; above 48 KB only as
#: dynamic shared memory after the opt-in attribute)
SMEM_LIMIT_BYTES = 232_448


class SharedMemoryBudgetError(ValueError):
    """A kernel's shapes need more shared memory than one block can have."""


def check_smem_budget(what: str, nbytes: int) -> int:
    """Raise ``SharedMemoryBudgetError`` unless ``nbytes`` fits one block."""
    if nbytes > SMEM_LIMIT_BYTES:
        raise SharedMemoryBudgetError(
            f"{what}: needs {nbytes} bytes of shared memory per block, over "
            f"Hopper's {SMEM_LIMIT_BYTES}-byte limit")
    return nbytes


def adc_smem_bytes(m: int, k: int) -> int:
    """The ADC kernel holds one query's (M, K) f32 LUT."""
    return m * k * 4


def refine_smem_bytes(g: int) -> int:
    """The refine scoring kernel holds the (5, G) f32 digit planes plus the
    243-entry byte → trits table (uint16 each)."""
    return TRITS_PER_BYTE * g * 4 + 243 * 2


def make_query_planes(q: torch.Tensor, g: int) -> torch.Tensor:
    """q (Q, D) → digit planes (Q, 5, G)."""
    pad = g * TRITS_PER_BYTE - q.shape[-1]
    qp = torch.nn.functional.pad(q.float(), (0, pad))
    return qp.reshape(q.shape[0], g, TRITS_PER_BYTE).transpose(1, 2) \
        .contiguous()


def query_params(q: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 resid_std: torch.Tensor, z: float) -> torch.Tensor:
    """(Q, 8) f32 rows [||q||, w0..w3, bias, z·resid_std, resid_std]."""
    nq = q.shape[0]
    rs = resid_std.float().reshape(1)
    head = torch.linalg.vector_norm(q.float(), dim=-1)[:, None]
    tail = torch.cat([w.float(), bias.float().reshape(1), z * rs, rs])
    return torch.cat([head, tail.expand(nq, 7)], dim=1).contiguous()


def record_table(scalars) -> torch.Tensor:
    """(N, 4) f32 [||δ||², ⟨x_c,δ⟩, ||δ||, rho] from ``RecordScalars``."""
    return torch.stack([scalars.delta_sq, scalars.cross, scalars.norm,
                        scalars.rho], dim=1).float().contiguous()


def level_table(level) -> torch.Tensor:
    """(N, 4) f32 [proj, norm, rho, 0] from a ``TRQLevel``."""
    return torch.stack([level.proj, level.norm, level.rho,
                        torch.zeros_like(level.proj)], dim=1) \
        .float().contiguous()


def level0_inputs(q, g, d0, delta_sq, cross, norm, rho, w, bias):
    """Planes (Q, 5, G), params (Q, 8) [||q||, w0..w3, bias, 0, 0] and
    scalars (Q, C, 5) [d0, ||δ||², ⟨x_c,δ⟩, ||δ||, rho]."""
    # a zero resid_std leaves the two trailing parameters 0
    params = query_params(q, w, bias, torch.zeros(1, device=q.device), 0.0)
    scalars = torch.stack([d0, delta_sq, cross, norm, rho], dim=-1)
    return make_query_planes(q, g), params, scalars.float().contiguous()


def refine_scores_batch(packed: torch.Tensor, q: torch.Tensor,
                        d0: torch.Tensor, delta_sq: torch.Tensor,
                        cross: torch.Tensor, norm: torch.Tensor,
                        rho: torch.Tensor, w: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """Level-0 refine of a query micro-batch → (Q, C, 3) [est, est_raw,
    margin].  packed (Q, C, G) per-query gathered codes, q (Q, D), the
    per-record scalars (Q, C); calibration w (4,) and bias are shared."""
    g = packed.shape[-1]
    planes, params, scalars = level0_inputs(q, g, d0, delta_sq, cross,
                                             norm, rho, w, bias)
    return _kernels.ternary_refine_batch(packed.contiguous(), planes,
                                         scalars, params)


def refine_scores(packed: torch.Tensor, q: torch.Tensor, d0: torch.Tensor,
                  delta_sq: torch.Tensor, cross: torch.Tensor,
                  norm: torch.Tensor, rho: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """``refine_scores_batch`` for one query: packed (C, G), q (D,), the
    scalars (C,) → (C, 3)."""
    g = packed.shape[-1]
    planes, params, scalars = level0_inputs(
        q.reshape(1, -1), g, d0, delta_sq, cross, norm, rho, w, bias)
    return _kernels.ternary_refine(packed.contiguous(), planes[0], scalars,
                                   params)
