"""Optimal ternary residual-direction encoding (FaTRQ §III-C).

The codeword ``c ∈ {-1,0,1}^D`` maximizing ``⟨c/||c||, δ/||δ||⟩`` keeps the
sign of the ``k*`` largest-magnitude components, ``k* = argmax_k S_k/√k``
over the descending prefix sums ``S_k``.  Trailing-axis semantics, so
batched inputs ``(..., D)`` work directly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TernaryCode(NamedTuple):
    """A ternary codeword plus its per-record scalars.

    code int8 ``(..., D)``; k int32 ``(...,)`` nonzero count; rho f32
    ``⟨e_δ, e_code⟩``; norm f32 ``||δ||``.
    """

    code: torch.Tensor
    k: torch.Tensor
    rho: torch.Tensor
    norm: torch.Tensor


def optimal_k(sorted_mags: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``k* = argmax_k S_k/√k`` for descending-sorted magnitudes → (k*, score).
    ``argmax`` returns the first maximum, as ``jnp.argmax`` does."""
    d = sorted_mags.shape[-1]
    csum = torch.cumsum(sorted_mags, dim=-1)
    ks = torch.arange(1, d + 1, dtype=sorted_mags.dtype,
                      device=sorted_mags.device)
    scores = csum / torch.sqrt(ks)
    idx = torch.argmax(scores, dim=-1)
    best = torch.gather(scores, -1, idx[..., None])[..., 0]
    return (idx + 1).to(torch.int32), best


def ternary_encode(delta: torch.Tensor) -> TernaryCode:
    """Encode residual(s) ``delta (..., D)`` into the optimal ternary code."""
    mags = delta.abs()
    # Stable sort: equal magnitudes keep index order, so "the first k of the
    # sorted list" is the same set of dims as the JAX encoder's.
    neg_sorted, order = torch.sort(-mags, dim=-1, stable=True)
    k_star, _ = optimal_k(-neg_sorted)
    # rank of each dim under that order: the inverse permutation (what a
    # second argsort of ``order`` returns, built by a scatter)
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(
        mags.shape[-1], device=mags.device).expand_as(order))
    mask = ranks < k_star[..., None]

    code = (torch.sign(delta) * mask).to(torch.int8)
    k = code.abs().to(torch.int32).sum(-1, dtype=torch.int32)
    norm = torch.linalg.vector_norm(delta, dim=-1)
    sel_sum = (mags * mask).sum(-1)
    safe = torch.clamp(norm * torch.sqrt(
        torch.clamp(k, min=1).to(delta.dtype)), min=1e-30)
    rho = torch.where(norm > 0, sel_sum / safe, torch.zeros_like(norm))
    return TernaryCode(code=code, k=k, rho=rho.to(torch.float32),
                       norm=norm.to(torch.float32))


def ternary_decode_direction(code: torch.Tensor) -> torch.Tensor:
    """Normalized direction ``e_code = code / ||code||`` as float32."""
    c = code.to(torch.float32)
    k = (c * c).sum(-1, keepdim=True)
    return c / torch.sqrt(torch.clamp(k, min=1.0))


def reconstruct(tc: TernaryCode) -> torch.Tensor:
    """Best L2 approximation of delta in span(e_code): ``||δ||·rho·e_code``."""
    return (tc.norm * tc.rho)[..., None] * ternary_decode_direction(tc.code)


def ternary_inner(code: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``⟨q, e_code⟩`` for ``code (..., D)`` int8 and ``q`` broadcastable."""
    c = code.to(q.dtype)
    k = c.abs().sum(-1)
    raw = (c * q).sum(-1)
    return raw / torch.sqrt(torch.clamp(k, min=1.0))


def brute_force_optimal(delta) -> torch.Tensor:
    """Exhaustive 3^D search of the best code for one residual (tiny D
    only), in float64 numpy as the reference's: the test oracle of
    ``ternary_encode``'s optimality.  Returns the int8 code (D,)."""
    import itertools

    import numpy as np

    delta = np.asarray(delta, dtype=np.float64)
    d = delta.shape[-1]
    if delta.ndim != 1 or d > 12:
        raise ValueError("the oracle takes one residual of at most 12 dims")
    best, best_ip = None, -np.inf
    for c in itertools.product((-1, 0, 1), repeat=d):
        c = np.array(c, dtype=np.float64)
        k = (c != 0).sum()
        if k == 0:
            continue
        ip = float(c @ delta) / np.sqrt(k)
        if ip > best_ip:
            best_ip, best = ip, c
    return torch.from_numpy(best.astype(np.int8))
