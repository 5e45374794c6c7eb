"""Input assembly for the kernels and the shared-memory budget check.

The refine kernel reads a query as 5 digit planes of (G,) floats (byte g's
digit i holds dim 5g+i), one parameter row per query, and per-record
scalars gathered by candidate id from (N, 4) tables built once per index.
"""

from __future__ import annotations

import torch

from repro_torch.core.packing import TRITS_PER_BYTE

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
